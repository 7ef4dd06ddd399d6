"""The timed path's input and output, seen from outside the aligner.

`Feeder` streams a read pool into named pipes, one writer thread a
pipe, in blocks of whole records.  It keeps every pipe full until `stop()`; then each writer ends
after the same number of blocks and closes its pipe, so the aligner
sees equal read counts on both ends of a pair and an end of file.

A test may cap the stream (`max_units`); a run never does.

`SamSink` stands in for `sys.stdout`: it stamps each write with the
time and keeps the text.  The aligner writes one text of SAM records a
chunk, so the last record of a write names the last read done.
"""

from __future__ import annotations

import errno
import fcntl
import os
import threading
import time

import numpy as np

F_SETPIPE_SZ = 1031


class Feeder:
    def __init__(self, paths, pool, block: int = 512, max_units=None):
        self.paths = paths
        self.max_blocks = (None if max_units is None
                           else -(-max_units // block))
        self.pool = pool
        self.block = block
        self.recs = [pool.records(e) for e in range(len(paths))]
        self.errors = []
        self._stop = threading.Event()
        self._limit = None
        self._blocks = [0] * len(paths)
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._write, args=(k,),
                                          daemon=True)
                         for k in range(len(paths))]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        """Let every writer end after the same number of blocks."""
        with self._lock:
            self._limit = max(self._blocks) + 1
        self._stop.set()

    def join(self, timeout: float) -> bool:
        end = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(end - time.monotonic(), 0.0))
        return not any(t.is_alive() for t in self._threads)

    def _open(self, path):
        """Open the pipe for writing once the reader has opened it."""
        while not self._stop.is_set():
            try:
                fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:
                if e.errno != errno.ENXIO:
                    raise
                time.sleep(0.01)
                continue
            flags = fcntl.fcntl(fd, fcntl.F_GETFL)
            fcntl.fcntl(fd, fcntl.F_SETFL, flags & ~os.O_NONBLOCK)
            try:
                fcntl.fcntl(fd, F_SETPIPE_SZ, 1 << 20)
            except OSError:
                pass
            return fd
        return None

    def _write(self, k: int) -> None:
        rec, col = self.recs[k]
        n, b = self.pool.size, self.block
        digits = 10 ** np.arange(9, -1, -1, dtype=np.int64)
        fd = None
        try:
            fd = self._open(self.paths[k])
            if fd is None:
                return
            i = 0
            while True:
                with self._lock:
                    if self._limit is not None and i >= self._limit:
                        break
                    if self.max_blocks is not None and i >= self.max_blocks:
                        break
                    self._blocks[k] = i
                g = i * b + np.arange(b, dtype=np.int64)
                out = rec[g % n]
                out[:, col:col + 10] = 48 + (g[:, None] // digits) % 10
                view = memoryview(out.tobytes())
                while view:
                    view = view[os.write(fd, view):]
                i += 1
        except BrokenPipeError:
            pass
        except Exception as e:     # a writer must never hang the run
            self.errors.append(repr(e))
        finally:
            if fd is not None:
                os.close(fd)


def last_index(text: str) -> int:
    """The stream index of the read named by the last SAM record of
    `text` (-1 where its last line is a header line)."""
    end = len(text) - 1 if text.endswith("\n") else len(text)
    line = text[text.rfind("\n", 0, end) + 1:end]
    if not line or line[0] == "@":
        return -1
    return int(line[1:line.index("\t")])


class SamSink:
    """sys.stdout for the aligner: keeps (time, text) of every write and
    fires `on_done(t, reads_done)` after each."""

    def __init__(self, on_done=None):
        self.writes = []
        self.on_done = on_done

    def write(self, text: str) -> int:
        t = time.perf_counter()
        self.writes.append((t, text))
        if self.on_done is not None:
            self.on_done(t, text)
        return len(text)

    def flush(self) -> None:
        pass

    def done_curve(self):
        """[(time, reads done)] after each write of records."""
        out, done = [], 0
        for t, text in self.writes:
            i = last_index(text)
            if i >= 0:
                done = max(done, i + 1)
                out.append((t, done))
        return out


class Capture:
    """sys.stderr for the aligner: keeps its text."""

    def __init__(self):
        self.parts = []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return len(text)

    def flush(self) -> None:
        pass

    def text(self) -> str:
        return "".join(self.parts)
