"""What a traced run reads: the aligner's `--trace` rows and the device
intervals of the profiler's trace.

Trace rows are JSON lines the port's `utils.metrics.Tracer` writes: `t`
(the host clock, `time.time()`, when the call ended), `kind`, `sec` (its
length) and, for device calls, `cells`; a `host_chunk` row has `reads`
(> 0: the chunk's seed, chain and plan; 0: its replay, pairing and SAM).

Device intervals come from `torch.profiler` (CUDA activity only) over
the window: every kernel, copy and memset, as (name, start, end) in
seconds on the host clock.  The profiler's clock is tied to the host's
by one marker kernel (`torch.cuda._sleep`, "spin_kernel") launched right
after a synchronisation at the window's start.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


def read_rows(path: str, t0: float, t1: float) -> list[dict]:
    """The trace rows whose call ended inside [t0, t1] (time.time())."""
    rows = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if t0 <= r["t"] <= t1:
                rows.append(r)
    return rows


def device_intervals(trace_json: str, t_marker: float, window_s: float):
    """[(name, start, end)] on the host clock of the device operations in
    the chrome trace at `trace_json` that overlap the window, clipped to
    it; the marker kernel's start is `t_marker`.  None without a marker."""
    with open(trace_json) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    marks = [e for e in ops if MARKER in e.get("name", "")]
    if not marks:
        return None
    base = min(m["ts"] for m in marks)
    out = []
    for e in ops:
        if MARKER in e["name"]:
            continue
        s = t_marker + (e["ts"] - base) * 1e-6
        t = s + e.get("dur", 0) * 1e-6
        s, t = max(s, t_marker), min(t, t_marker + window_s)
        if t > s:
            out.append((e["name"], s, t))
    return out


def union_seconds(intervals) -> float:
    """Seconds covered by at least one of [(name, start, end)]."""
    total, end = 0.0, None
    for _, s, t in sorted(intervals, key=lambda x: x[1]):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def idle_gaps(intervals, t0: float, t1: float):
    """[(start, end)] of the stretches of [t0, t1] no operation covers."""
    gaps, cur = [], t0
    for _, s, t in sorted(intervals, key=lambda x: x[1]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def host_layer(row: dict) -> str:
    """The host layer a trace row stands for."""
    k = row["kind"]
    if k == "host_chunk":
        return "host_start" if row.get("reads", 0) > 0 else "host_finish"
    if k.startswith("rescue_w"):
        return "rescue"
    if k.startswith("cigar_r"):
        return "cigar"
    if k.startswith("extend"):
        return "extend_call"
    return k


def name_gap(rows, start: float, end: float) -> str:
    """The host rows open over the middle of a gap, joined by '+'
    ('none' where no row was)."""
    mid = 0.5 * (start + end)
    names = sorted({host_layer(r) for r in rows
                    if r["t"] - r["sec"] <= mid <= r["t"]})
    return "+".join(names) or "none"


def breakdown(intervals, rows, t0, t1):
    """The `breakdown` of a traced run: the device operations that took
    most time, and the longest idle gaps named by the host rows open
    over them."""
    by_name = {}
    for name, s, t in intervals:
        name = name[:100]
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(intervals, t0, t1), key=lambda g: g[0] - g[1])
    named = [[name_gap(rows, s, t), t - s] for s, t in gaps[:10]]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
