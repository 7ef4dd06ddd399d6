"""Runtime metrics and span tracing (`mem --trace OUT.jsonl`).

The reference's observability is an ASE transaction log plus a DSM
busy-bitmap the host polls (SURVEY.md §5); its DSM layout reserves
perf-counter fields that were never implemented
(bwa_mem_sw.v:93-101).  Here both become first-class: span rows (the
transaction.tsv analogue) and cumulative counters.

A row is one span: a stretch of one host thread, stamped from
`time.time()` (the clock a device trace is mapped onto) when the span
opens and when the host call it wraps returns; no row waits for the
device.  Every row has

- `kind`, `t` (the end, seconds to the microsecond) and `sec` (its
  length);
- `id`, `parent` (the id of the span open around it in the same thread,
  else null) and `chunk` (the CLI loop's chunk number in that thread,
  else null);
- the kind's own fields: `reads` on `host_chunk` (> 0 the chunk's start:
  seed, chain and plan; 0 its finish: replay, pairing and SAM) and
  `packed_reads` on its start (its reads, where they came as an
  io/fastq.ReadBatch, not as lists made into one; else 0);
  `n_tasks`, `cells`, `Bp`, `qmax`, `tmax` on a device call's row, and
  `h2d_bytes`, `copies` (its host-to-device copies) where the backend
  made them; `n_used` on a rescue batch (the results the replay
  applied, of its `n_tasks` computed); `dims` on a CIGAR round ([qlen,
  tlen, w, tasks] for each distinct task shape); `n_reads`,
  `ovf_reads`, `ovf_jobs`, `exact_reads`, `split_rounds`, `split_jobs`
  and `records` (the 64-byte block records the seeding kernels read,
  where they count them) on `seed.device`, `n_reads` on `seed.exact`;
  `generation`, `collected` on `gc`.

The kinds, from the CLI down (children indented under their parent):

    input.read          blocked in the FASTQ stream's read (io/fastq.py)
    input.parse         a block's records parsed into columns (C++), and
                        the chunks cut from them
    chunk.prep          a chunk's inputs: a ReadBatch as it is, or the
                        names, qualities and base lists of the Python host
    host_chunk (start)  NativePipeline._chunk_start
      chunk.pack          the read matrix of the chunk's ReadBatch
      seed.device         `--device-seed`: the seeder's call
        seed.smem_all       the reads' copy in, bwt_smem_all, copy back
        seed.reseed         a re-seed round: bwt_smem1 and its copies
        seed.sa             bwt_sa over the seed rows and its copies
        seed.exact          overflowed reads seeded by the C++ engine
      seed, chain_plan    C++ phases of mp_chunk_start (mp_phase_stamps)
    fused.fill          mp_prepare_fused .. mp_fill_fused[_idx]
    extend_fused        the fused extension's device call
      fused.h2d, fused.launch, fused.wait
    extend_L0 .. R1     the per-phase calls (--phased)
    fused.done          mp_fused_done
    host_chunk (finish) replay, rescue, CIGARs, pairing, SAM
      replay, pestat, pair  C++ phases of mp_finalize_pe, mp_pe_prepare,
                            mp_finalize_pe_tail
      rescue.build        mp_rescue_begin: the chunk's task superset, once
      rescue_w<k>         batch k of it, a device call (one a chunk)
        rescue.fill, rescue.h2d, rescue.launch, rescue.wait
      rescue.apply        mp_rescue_apply: the batch's results stored
      rescue.replay       mp_rescue_replay: bwa's skip test over them
      cigar_r<k>          a CIGAR round's device call
        cigar.fill, cigar.h2d, cigar.launch, cigar.wait
      sam.emit            the SAM text in C++ (mp_emit_sam)
    chunk.join          SE: the main thread waits for a chunk in flight
    sam.write           the SAM text written out
    gc                  a collection of generation 2, or one over 1 ms
    trace.flush         a block of rows written

`<call>.h2d` is the pageable host-to-device copies (each blocks the
host), `.launch` the gathers and the kernel enqueued, `.wait` the copy
back (the stream drains first).  Rows are held in memory and written as
JSON lines in blocks: when FLUSH_ROWS are held and no span is open in
the writing thread, and at close().  Without a path nothing is kept and
no callback is registered; the port's call sites then test `tracer is
None` once a span (`span`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import threading
import time

FLUSH_ROWS = 1 << 15


@dataclasses.dataclass
class Counters:
    reads: int = 0
    tasks: int = 0
    band_cells: int = 0
    device_batches: int = 0
    h2d_bytes: int = 0
    rescue_tasks: int = 0     # device rescue: tasks computed
    rescue_used: int = 0      # of them, the results the replay applied
    seed_reads: int = 0       # device seeding: reads seeded
    seed_ovf_reads: int = 0   # of them, first rounds that overflowed
    seed_records: int = 0     # block records the seeding kernels read
    packed_reads: int = 0     # reads that reached NativePipeline as a
    #                           ReadBatch (of `reads`)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_OFF = contextlib.nullcontext()


def span(tracer, kind: str, **fields):
    """`tracer`'s span of `kind` as a context manager (`as` gives the
    Span, whose `fields` the block may add to), or a shared no-op one
    (`as` gives None) when tracer is None."""
    return _OFF if tracer is None else Span(tracer, kind, fields)


class Span:
    """One open span; entering stamps its start, leaving its end."""

    __slots__ = ("tracer", "kind", "fields", "id", "parent", "chunk", "t0")

    def __init__(self, tracer, kind, fields):
        self.tracer, self.kind, self.fields = tracer, kind, fields

    def __enter__(self):
        self.tracer._open(self)
        return self

    def __exit__(self, *exc):
        self.tracer._close(self)
        return False


class Tracer:
    """Span rows and counters; Tracer(None) keeps the counters only."""

    def __init__(self, path: str | None = None):
        self._f = open(path, "a") if path else None
        self.counters = Counters()
        self._lock = threading.Lock()   # counters: --inflight threads
        self._rows = collections.deque()
        self._flushing = threading.Lock()   # one thread writes a block
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._gc_t0 = None
        if self._f:
            gc.callbacks.append(self._gc)

    @property
    def chunk(self):
        """The CLI loop's chunk number in this thread (None: unset)."""
        return getattr(self._local, "chunk", None)

    @chunk.setter
    def chunk(self, n) -> None:
        self._local.chunk = n

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, sp: Span) -> None:
        st = self._stack()
        sp.id = next(self._ids)
        sp.parent = st[-1].id if st else None
        sp.chunk = self.chunk
        st.append(sp)
        sp.t0 = time.time()

    def _close(self, sp: Span) -> None:
        t1 = time.time()
        st = self._stack()
        st.pop()
        self._count(sp.kind, sp.fields)
        self._keep(t1, t1 - sp.t0, sp.kind, sp.id, sp.parent, sp.chunk,
                   sp.fields)
        if not st and len(self._rows) >= FLUSH_ROWS \
                and self._flushing.acquire(blocking=False):
            try:
                self._flush()
            finally:
                self._flushing.release()

    def note(self, **counts) -> None:
        """Add `counts` (h2d_bytes, copies) to the innermost open span
        of this thread; h2d_bytes also to the counters."""
        st = self._stack()
        if st:
            f = st[-1].fields
            for k, v in counts.items():
                f[k] = f.get(k, 0) + v
        with self._lock:
            self.counters.h2d_bytes += counts.get("h2d_bytes", 0)

    def stamp(self, kind: str, t0: float, t1: float, **fields) -> None:
        """A finished row [t0, t1] (time.time() seconds), the child of
        the span open in this thread: C++ phase stamps, collections."""
        st = self._stack()
        self._keep(t1, t1 - t0, kind, next(self._ids),
                   st[-1].id if st else None, self.chunk, fields)

    def amend(self, sp: Span, **fields) -> None:
        """Add `fields` to the row of `sp`, a span this thread closed
        inside a span still open (so no block has written the row yet);
        `n_used` also goes to the counters' `rescue_used`."""
        with self._lock:
            sp.fields.update(fields)
            self.counters.rescue_used += fields.get("n_used", 0)

    def _count(self, kind, fields) -> None:
        with self._lock:
            c = self.counters
            if "n_tasks" in fields:
                c.tasks += fields["n_tasks"]
                c.band_cells += fields.get("cells", 0)
                c.device_batches += 1
                if kind.startswith("rescue_w"):
                    c.rescue_tasks += fields["n_tasks"]
            elif kind == "host_chunk":
                c.reads += fields["reads"]
                c.packed_reads += fields.get("packed_reads", 0)
            elif kind == "seed.device":
                c.seed_reads += fields["n_reads"]
                c.seed_ovf_reads += fields.get("ovf_reads", 0)
                c.seed_records += fields.get("records", 0)

    def _keep(self, t1, sec, kind, id_, parent, chunk, fields) -> None:
        if self._f:
            self._rows.append((t1, sec, kind, id_, parent, chunk, fields))

    def _gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = time.time()
        elif self._gc_t0 is not None:
            t0, t1, self._gc_t0 = self._gc_t0, time.time(), None
            if info["generation"] == 2 or t1 - t0 > 1e-3:
                self.stamp("gc", t0, t1, generation=info["generation"],
                           collected=info["collected"])

    def _flush(self) -> None:
        """Write the rows held (appends from other threads meanwhile
        stay for the next block); the write is a `trace.flush` row."""
        t0 = time.time()
        rows = self._rows
        lines = []
        for _ in range(len(rows)):
            t1, sec, kind, id_, parent, chunk, fields = rows.popleft()
            lines.append(json.dumps({
                "t": round(t1, 6), "kind": kind, **fields,
                "sec": round(sec, 6), "id": id_, "parent": parent,
                "chunk": chunk}))
        self._f.write("\n".join(lines) + "\n" if lines else "")
        self._f.flush()
        self.stamp("trace.flush", t0, time.time(), rows=len(lines))

    def close(self) -> None:
        if self._f:
            if self._gc in gc.callbacks:
                gc.callbacks.remove(self._gc)
            with self._flushing:
                self._flush()
            self._f.close()
            self._f = None


def band_cells(qlen, tlen, w) -> int:
    """The reference's GCUPS accounting: target rows x band width
    (min(qlen, 2w+1)) summed over tasks.  That is the band's rectangle,
    about 1.8x the cells the extension computes on `mem`'s batches
    (z-drop and the band's ends cut the rest)."""
    import numpy as np

    bw = np.minimum(np.asarray(qlen), 2 * np.asarray(w) + 1)
    return int((np.asarray(tlen, np.int64) * bw).sum())
