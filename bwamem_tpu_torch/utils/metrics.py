"""Runtime metrics and batch tracing.

The reference's observability is an ASE transaction log plus a DSM
busy-bitmap the host polls (SURVEY.md §5); its DSM layout reserves
perf-counter fields that were never implemented
(bwa_mem_sw.v:93-101).  Here both become first-class: per-batch trace
records (the transaction.tsv analogue) and cumulative counters
including the GCUPS accounting used by bench.py.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time


@dataclasses.dataclass
class Counters:
    reads: int = 0
    tasks: int = 0
    band_cells: int = 0
    device_batches: int = 0
    device_seconds: float = 0.0
    host_seconds: float = 0.0

    def gcups(self) -> float:
        return (self.band_cells / self.device_seconds / 1e9
                if self.device_seconds else 0.0)

    def reads_per_sec(self) -> float:
        total = self.device_seconds + self.host_seconds
        return self.reads / total if total else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["gcups"] = round(self.gcups(), 3)
        d["reads_per_sec"] = round(self.reads_per_sec(), 1)
        return d


class Tracer:
    """Append-only JSONL batch trace (the transaction.tsv analogue).

    Pass path=None for a no-op tracer (zero overhead in production)."""

    def __init__(self, path: str | None = None):
        self._f = open(path, "a") if path else None
        self.counters = Counters()
        self._lock = threading.Lock()  # double-buffered chunks share one

    def batch(self, kind: str, n_tasks: int, band_cells: int,
              seconds: float, **extra) -> None:
        with self._lock:
            self.counters.tasks += n_tasks
            self.counters.band_cells += band_cells
            self.counters.device_batches += 1
            self.counters.device_seconds += seconds
            if self._f:
                self._f.write(json.dumps({
                    "t": round(time.time(), 3), "kind": kind,
                    "n_tasks": n_tasks, "cells": band_cells,
                    "sec": round(seconds, 6), **extra}) + "\n")
                self._f.flush()

    def host(self, reads: int, seconds: float) -> None:
        with self._lock:
            self.counters.reads += reads
            self.counters.host_seconds += seconds
            if self._f:
                # per-chunk host (C++ seed+chain+plan) rows alongside the
                # device rows: without them a trace cannot separate the
                # startup page-in of gigabase occ tables from the steady
                # per-chunk host cost (round-5 GRCh38 profiling)
                self._f.write(json.dumps({
                    "t": round(time.time(), 3), "kind": "host_chunk",
                    "reads": reads, "sec": round(seconds, 6)}) + "\n")
                self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()


def band_cells(qlen, tlen, w) -> int:
    """The reference's GCUPS accounting: cells actually computed =
    rows x band width (min(qlen, 2w+1)) summed over tasks."""
    import numpy as np

    bw = np.minimum(np.asarray(qlen), 2 * np.asarray(w) + 1)
    return int((np.asarray(tlen, np.int64) * bw).sum())
