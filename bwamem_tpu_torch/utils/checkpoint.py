"""Checkpoint / resume for long multi-host runs: a shard manifest of
processed read ranges.

The reference has no checkpointing — batches are stateless and
re-submittable (SURVEY.md §5), and this build keeps that property: the
unit of recovery is a read-range shard, and resuming = re-aligning only
the ranges not yet marked done.  The manifest is a JSONL of completed
ranges per shard, written atomically, so a killed worker loses at most
its in-flight batch.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class ReadRange:
    shard: int
    start: int    # first read index (inclusive)
    end: int      # last read index (exclusive)


class Manifest:
    def __init__(self, path: str):
        self.path = path
        self._done: set[tuple[int, int, int]] = set()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        d = json.loads(line)
                        self._done.add((d["shard"], d["start"], d["end"]))

    def mark_done(self, r: ReadRange) -> None:
        key = (r.shard, r.start, r.end)
        if key in self._done:
            return
        self._done.add(key)
        with open(self.path, "a") as f:
            f.write(json.dumps(
                {"shard": r.shard, "start": r.start, "end": r.end}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def is_done(self, r: ReadRange) -> bool:
        return (r.shard, r.start, r.end) in self._done

    def pending(self, shard: int, n_reads: int, batch: int,
                ) -> list[ReadRange]:
        """Ranges of `shard` still to process for a file of n_reads."""
        out = []
        for s in range(0, n_reads, batch):
            r = ReadRange(shard, s, min(s + batch, n_reads))
            if not self.is_done(r):
                out.append(r)
        return out
