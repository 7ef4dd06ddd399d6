"""Codec for the reference FPGA's exact task/result wire formats.

This module exists for format parity with the reference hardware: it
packs/unpacks the byte-exact 256 KB task-batch stream that
`sw_pe_array_task_parse.v` consumes and the 5-word result records that
`fill_resulBuf.v` emits (decoded field-by-field in SURVEY.md §2.3/§2.4).
The TPU compute path does NOT use this format (see tasks.py for why);
it is the interop/golden layer: a batch captured from the original
host software can be decoded into our SoA batches, and our results can
be re-encoded into the FPGA's result-buffer layout.

Layout (per PE-array batch = 65536 little-endian u32 words):
  word 0          {e_ins[31:24], o_ins[23:16], e_del[15:8], o_del[7:0]}
  word 1          {-, w[23:16], pen_clip_right[15:8], pen_clip_left[7:0]}
  word 2          numTasks
  words 8+8i..    8-word descriptor of task i:
     d0 {tlen_left[26:16],  qlen_left[7:0]}
     d1 {tlen_right[26:16], qlen_right[7:0]}
     d2 taskDataPos (payload offset; host-buffer-relative, rebased via
        word 10: bias = 8 + 8*numTasks - word[10])
     d3 {qBeg_ori[31:16], regScore[15:0]}
     d4 h0[7:0]
     d5 max_ins
     d6 max_del
     d7 opaque task id (echoed as result word 0)
  words 8+8n..    4-bit base payloads, MSB-first, 8 per word, per task:
                  left query, right query, left target, right target
                  (ceil(total_len/8) words each, task-ordered)

Result records (5 u32 each, densely packed, 0xFFFFFFFF sentinel):
  r0 task id
  r1 {qEnd[31:16], qBeg[15:0]}
  r2 {rEnd[31:16], rBeg[15:0]}   (int16; rBeg/rEnd relative to the anchor)
  r3 {trueScore[31:16], score[15:0]}
  r4 final band width = max(aw_left, aw_right)
"""

from __future__ import annotations

import dataclasses

import numpy as np

TBB_WORDS = 65536   # 4096 cache lines x 16 u32 (bwa_mem_sw.v:163-165)
RBB_WORDS = 4096    # 256 cache lines x 16 u32 (bwa_mem_sw.v:167-169)
MAX_TASKS_PER_BATCH = RBB_WORDS // 5  # 819, fill_resulBuf.v:377-378
SENTINEL = 0xFFFFFFFF


@dataclasses.dataclass
class WireTask:
    """One two-sided extension task as the FPGA sees it."""

    q_left: np.ndarray    # already-reversed left query bases (codes 0..4)
    q_right: np.ndarray
    t_left: np.ndarray    # already-reversed left target bases
    t_right: np.ndarray
    qbeg_ori: int         # query begin of the seed (descriptor d3 hi)
    regscore: int         # current chain score (d3 lo)
    h0: int               # seed initial score (d4)
    max_ins: int          # band bound (d5)
    max_del: int          # band bound (d6)
    task_id: int          # opaque echo (d7)


@dataclasses.dataclass
class WireHeader:
    o_del: int
    e_del: int
    o_ins: int
    e_ins: int
    pen_clip_left: int
    pen_clip_right: int
    w: int


@dataclasses.dataclass
class WireResult:
    task_id: int
    qbeg: int
    qend: int
    rbeg: int   # relative to the seed's reference anchor (negative or 0)
    rend: int
    score: int
    true_score: int
    w_used: int


def _pack_bases(words: np.ndarray, start_word: int, bases: np.ndarray) -> int:
    """Append 4-bit codes MSB-first, 8 per u32 (proc_element.v:1677, 1638).
    Returns the number of words written.  `bases` must be a concatenation of
    all four segments of one task (the stream is contiguous per task)."""
    n = len(bases)
    nw = (n + 7) // 8
    padded = np.zeros(nw * 8, np.uint32)
    padded[:n] = bases
    grp = padded.reshape(nw, 8)
    shifts = np.uint32(28) - 4 * np.arange(8, dtype=np.uint32)
    words[start_word : start_word + nw] = (grp << shifts).sum(
        axis=1, dtype=np.uint32)
    return nw


def _unpack_bases(words: np.ndarray, start_word: int, n: int) -> np.ndarray:
    nw = (n + 7) // 8
    grp = words[start_word : start_word + nw, None]
    shifts = np.uint32(28) - 4 * np.arange(8, dtype=np.uint32)
    return ((grp >> shifts) & 0xF).reshape(-1)[:n].astype(np.int8)


def pack_batch(header: WireHeader, tasks: list[WireTask]) -> np.ndarray:
    """Encode one PE-array batch into the 65536-word TBB image."""
    n = len(tasks)
    assert n <= MAX_TASKS_PER_BATCH, "RBB capacity: <=819 tasks (SURVEY §2.3)"
    w = np.zeros(TBB_WORDS, np.uint32)
    w[0] = ((header.e_ins & 0xFF) << 24 | (header.o_ins & 0xFF) << 16
            | (header.e_del & 0xFF) << 8 | (header.o_del & 0xFF))
    w[1] = ((header.w & 0xFF) << 16 | (header.pen_clip_right & 0xFF) << 8
            | (header.pen_clip_left & 0xFF))
    w[2] = n
    pos = 8 + 8 * n
    for i, t in enumerate(tasks):
        d = 8 + 8 * i
        ql, qr = len(t.q_left), len(t.q_right)
        tl, tr = len(t.t_left), len(t.t_right)
        assert ql <= 255 and qr <= 255 and tl <= 2047 and tr <= 2047
        assert ql + qr + tl + tr <= 2048, "query_mem capacity"
        w[d + 0] = (tl & 0x7FF) << 16 | (ql & 0xFF)
        w[d + 1] = (tr & 0x7FF) << 16 | (qr & 0xFF)
        w[d + 2] = pos  # host-buffer offset; we pack with bias == 0
        w[d + 3] = (t.qbeg_ori & 0xFFFF) << 16 | (t.regscore & 0xFFFF)
        w[d + 4] = t.h0 & 0xFF
        w[d + 5] = t.max_ins & 0xFFFFFFFF
        w[d + 6] = t.max_del & 0xFFFFFFFF
        w[d + 7] = t.task_id & 0xFFFFFFFF
        payload = np.concatenate([t.q_left, t.q_right, t.t_left, t.t_right])
        pos += _pack_bases(w, pos, payload.astype(np.uint32))
    assert pos <= TBB_WORDS, "task payload overflows the 256 KB TBB"
    return w


def unpack_batch(w: np.ndarray) -> tuple[WireHeader, list[WireTask]]:
    """Decode a TBB image (the task_parse.v + proc_element.v walk)."""
    header = WireHeader(
        o_del=int(w[0] & 0xFF), e_del=int((w[0] >> 8) & 0xFF),
        o_ins=int((w[0] >> 16) & 0xFF), e_ins=int((w[0] >> 24) & 0xFF),
        pen_clip_left=int(w[1] & 0xFF), pen_clip_right=int((w[1] >> 8) & 0xFF),
        w=int((w[1] >> 16) & 0xFF),
    )
    n = int(w[2])
    bias = (8 + 8 * n) - int(w[10]) if n else 0  # task_parse.v:1928-1929
    tasks = []
    for i in range(n):
        d = 8 + 8 * i
        ql, tl = int(w[d] & 0xFF), int((w[d] >> 16) & 0x7FF)
        qr, tr = int(w[d + 1] & 0xFF), int((w[d + 1] >> 16) & 0x7FF)
        pos = bias + int(w[d + 2])
        payload = _unpack_bases(w, pos, ql + qr + tl + tr)
        tasks.append(WireTask(
            q_left=payload[:ql],
            q_right=payload[ql:ql + qr],
            t_left=payload[ql + qr:ql + qr + tl],
            t_right=payload[ql + qr + tl:],
            qbeg_ori=int((w[d + 3] >> 16) & 0xFFFF),
            regscore=int(w[d + 3] & 0xFFFF),
            h0=int(w[d + 4] & 0xFF),
            max_ins=int(w[d + 5]),
            max_del=int(w[d + 6]),
            task_id=int(w[d + 7]),
        ))
    return header, tasks


def _s16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def pack_results(results: list[WireResult]) -> np.ndarray:
    """Encode results as the RBB image (5 words/task + sentinel)."""
    assert len(results) <= MAX_TASKS_PER_BATCH
    w = np.zeros(RBB_WORDS, np.uint32)
    a = 0
    for r in results:
        w[a + 0] = r.task_id & 0xFFFFFFFF
        w[a + 1] = (r.qend & 0xFFFF) << 16 | (r.qbeg & 0xFFFF)
        w[a + 2] = (r.rend & 0xFFFF) << 16 | (r.rbeg & 0xFFFF)
        w[a + 3] = (r.true_score & 0xFFFF) << 16 | (r.score & 0xFFFF)
        w[a + 4] = r.w_used & 0xFFFFFFFF
        a += 5
    if a < RBB_WORDS:
        w[a] = SENTINEL
    return w


def unpack_results(w: np.ndarray) -> list[WireResult]:
    out = []
    a = 0
    while a + 5 <= len(w) and w[a] != SENTINEL:
        out.append(WireResult(
            task_id=int(w[a]),
            qbeg=_s16(int(w[a + 1])), qend=_s16(int(w[a + 1]) >> 16),
            rbeg=_s16(int(w[a + 2])), rend=_s16(int(w[a + 2]) >> 16),
            score=_s16(int(w[a + 3])), true_score=_s16(int(w[a + 3]) >> 16),
            w_used=int(w[a + 4]),
        ))
        a += 5
    return out
