"""One run of one cell: set-up, the measured window, the metrics and the
comparison with the reference aligner.

The window drives the port's own command line, `bwamem_tpu_torch mem`,
in this process: the reads go in through named pipes (one writer thread
a pipe, harness.feed), the SAM comes back through a `sys.stdout` that
stamps each write, so the CLI's chunk loop, its `--inflight` pipeline,
the backends and the native pipeline are what is timed.  The loop is
closed: the aligner takes reads as fast as it can, as from a file.

Set-up runs from the process's start until the SAM of the warm-up reads
(`warmup_chunks` chunks) is out; the window starts there and lasts
`--seconds`.  A checkout's first run of a configuration also makes its
genome and the port's index (`bwamem_tpu_torch index`) in the cache
directory `gpubench/.cache/<config>/`; later runs read them.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

from harness import feed, trace
from harness.genome import make_genome, read_fasta_codes, write_fasta
from harness.reads import make_pool

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(HERE, ".cache")
BARRED = ("jax", "jaxlib", "flax", "bwamem_tpu")
SETUP_LIMIT_S = 1000.0     # a first run, which builds, may take 1,200 s


class RunError(Exception):
    """A run that cannot give a result; the message says why."""


def barred_modules() -> list[str]:
    """Loaded modules whose top-level name is barred (compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BARRED})


def cpu_seconds() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def card() -> str:
    """'name, power limit' of card 0 as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def chunk_size(mem_args) -> int:
    """`-b` of the mem options (the CLI's default 512 without it)."""
    return int(mem_args[mem_args.index("-b") + 1]) if "-b" in mem_args \
        else 512


def load_cell(bench: dict, workload: str, data_dir: str = HERE):
    """(workload, config, traffic) entries of `workload`, the config and
    traffic found by name under `data_dir`."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    with open(os.path.join(data_dir, "configs", wl["config"] + ".json")) \
            as f:
        cfg = json.load(f)
    with open(os.path.join(data_dir, "traffic", wl["traffic"] + ".json")) \
            as f:
        mix = json.load(f)
    return wl, cfg, mix


def cli():
    """The port's command-line module, looked up at each call."""
    import bwamem_tpu_torch.__main__ as m

    return m


def prepare(cfg: dict, cache: str = CACHE, log=print) -> str:
    """The FASTA of the configuration's genome, indexed by the port; made
    in the cache on the first run (then renamed into place whole)."""
    want = json.dumps(cfg["genome"], sort_keys=True)
    done = os.path.join(cache, cfg["name"])
    fa = os.path.join(done, "genome.fa")
    meta = os.path.join(done, "genome.json")
    if os.path.exists(meta):
        with open(meta) as f:
            if f.read() == want:
                return fa
        shutil.rmtree(done)
    part = done + ".part"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    t0 = time.perf_counter()
    write_fasta(os.path.join(part, "genome.fa"), cfg["contig"],
                make_genome(cfg["genome"]))
    err = feed.Capture()
    old = sys.stderr
    sys.stderr = err
    try:
        rc = cli().main(["index", os.path.join(part, "genome.fa")])
    finally:
        sys.stderr = old
    if rc != 0:
        raise RunError(f"index failed: {err.text()[-2000:]}")
    with open(os.path.join(part, "genome.json"), "w") as f:
        f.write(want)
    os.rename(part, done)
    log(f"[gpubench] made {fa} and its index in "
        f"{time.perf_counter() - t0:.1f} s")
    return fa


class _Window:
    """The window's start, set by the first write that completes the
    warm-up reads."""

    def __init__(self, warm: int):
        self.warm = warm
        self.started = threading.Event()
        self.t = self.wall = self.cpu = None

    def on_write(self, t, text):
        if self.started.is_set():
            return
        if feed.last_index(text) + 1 >= self.warm:
            self.t, self.wall, self.cpu = t, time.time(), cpu_seconds()
            self.started.set()


def done_at(curve, t: float) -> int:
    """Stream units done by time t on a [(time, done)] curve."""
    d = 0
    for tc, dc in curve:
        if tc > t:
            break
        d = dc
    return d


def run(opts, bench: dict, *, data_dir: str = HERE, cache: str = CACHE,
        t_start: float, require_cuda: bool = True, log=None,
        max_units=None) -> dict:
    """One run; returns the result line as a dict (with the compared
    numbers under `checks`) or raises RunError.  The CPU tests pass
    require_cuda=False and cap the stream at `max_units` reads (pairs)."""
    log = log or (lambda m: print(m, file=sys.__stderr__, flush=True))
    wl, cfg, mix = load_cell(bench, opts.workload, data_dir)
    import torch

    on_card = torch.cuda.is_available()
    if require_cuda and (not on_card
                         or torch.cuda.device_count() < wl["chips"]):
        raise RunError(f"needs {wl['chips']} CUDA device(s); "
                       f"torch.cuda.is_available() = {on_card}, "
                       f"device_count = {torch.cuda.device_count()}")
    fa = prepare(cfg, cache, log)
    pool = make_pool(read_fasta_codes(fa), mix, opts.seed)
    b = chunk_size(cfg["mem_args"])
    ends = len(pool.ends)              # reads a stream unit
    warm = mix["warmup_chunks"] * b
    tmp = tempfile.mkdtemp(prefix="gpubench-", dir=os.environ.get("TMPDIR"))
    try:
        return _run(opts, bench, wl, cfg, mix, fa, pool, b, ends, warm,
                    tmp, t_start, on_card, log, max_units)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(opts, bench, wl, cfg, mix, fa, pool, b, ends, warm, tmp, t_start,
         on_card, log, max_units):
    import torch

    fifos = [os.path.join(tmp, f"in{k}.fq") for k in range(ends)]
    for p in fifos:
        os.mkfifo(p)
    rows_path = os.path.join(tmp, "rows.jsonl")
    argv = ["mem", *cfg["mem_args"],
            *(["--trace", rows_path] if opts.trace else []), fa, *fifos]
    win = _Window(warm)
    sink = feed.SamSink(win.on_write)
    err = feed.Capture()
    feeder = feed.Feeder(fifos, pool, max_units=max_units)
    outcome = {}

    def align():
        try:
            outcome["rc"] = cli().main(argv)
        except BaseException:           # noqa: BLE001 - reported below
            outcome["rc"] = 1
            outcome["tb"] = traceback.format_exc()

    mem = threading.Thread(target=align, daemon=True)
    prof = None
    if opts.trace:
        # started before the aligner: the profiler's own start-up takes
        # seconds, and the window is read out of its trace by the clock
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = sink, err
    try:
        feeder.start()
        mem.start()
        while not win.started.wait(0.5):
            if not mem.is_alive() or \
                    time.perf_counter() - t_start > SETUP_LIMIT_S:
                break
        if not win.started.is_set():
            raise RunError("the warm-up was not out (mem alive: "
                           f"{mem.is_alive()}): "
                           + outcome.get("tb", err.text())[-3000:])
        t_marker = None
        if opts.trace:
            torch.cuda.synchronize()
            t_marker = time.time()
            torch.cuda._sleep(100)
        time.sleep(max(win.t + opts.seconds - time.perf_counter(), 0.0))
        t_end, wall_end, cpu_end = (time.perf_counter(), time.time(),
                                    cpu_seconds())
        feeder.stop()
        if prof is not None:
            torch.cuda.synchronize()
            wall_end = time.time()
            prof.stop()
        mem.join(600)
        feeder.join(60)
    finally:
        sys.stdout, sys.stderr = old
    if mem.is_alive():
        raise RunError("mem did not end within 600 s of the window")
    if outcome.get("rc") != 0:
        raise RunError(f"mem exited {outcome.get('rc')}: "
                       + outcome.get("tb", err.text())[-3000:])
    if feeder.errors:
        raise RunError(f"input writer failed: {feeder.errors}")
    found = barred_modules()
    if found:
        raise RunError(f"modules loaded that the port must not load: "
                       f"{found}")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    curve = sink.done_curve()
    done0, done1 = done_at(curve, win.t), done_at(curve, t_end)
    window_s = t_end - win.t
    reads = (done1 - done0) * ends
    if reads == 0:
        raise RunError("no read came out in the window")
    thirds = [(done_at(curve, win.t + window_s * (i + 1) / 3)
               - done_at(curve, win.t + window_s * i / 3)) * ends
              / (window_s / 3) for i in range(3)]
    log(f"[gpubench] {opts.workload} seed {opts.seed}: {reads} reads in "
        f"{window_s:.3f} s (reads/s by thirds of the window: "
        f"{', '.join(f'{x:.1f}' for x in thirds)}), "
        f"{(cpu_end - win.cpu) / window_s:.3f} cores busy, set-up "
        f"{win.t - t_start:.3f} s; {card() if on_card else 'cpu'}")
    if done1 > pool.size:
        log(f"[gpubench] the window repeated reads: {done1} stream units "
            f"from a pool of {pool.size}")

    result = {"correct": False, "attempted": reads, "failed": 0,
              "metrics": {}, "device": {
                  "platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card
                  else "cpu",
                  "count": wl["chips"], "memory_peak_bytes": memory_peak}}
    if opts.trace:
        ctx = _traced(tmp, rows_path, prof, t_marker, win.wall, wall_end,
                      reads, result)
        spans = {}
        for r in ctx.rows:
            n, s = spans.get(trace.host_layer(r), (0, 0.0))
            spans[trace.host_layer(r)] = (n + 1, s + r["sec"])
        log(f"[gpubench] rows in the window (count, seconds): {spans}; "
            f"device busy {ctx.busy_s:.6f} of {ctx.window_s:.6f} s")
        for line in err.text().splitlines():
            if line.startswith(("[mem] align", "[mem] device seeding",
                                "[mem] counters")):
                log(f"[gpubench] {line[:600]}")
        result["metrics"] = _per_layer(bench, wl["name"], ctx)
    else:
        e2e = {
            "reads_per_s": (reads / window_s, "reads/s"),
            "cpu_s_per_mread": ((cpu_end - win.cpu) / (reads / 1e6),
                                "s/Mreads"),
            "setup_s": (win.t - t_start, "s"),
        }
        for m in bench["end_to_end"]:
            if "workloads" in m and wl["name"] not in m["workloads"]:
                continue
            v, unit = e2e[m["name"]]
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": unit}

    # the program's state is gone with mem's frames: free its memory
    # before the reference builds its index on the card
    del feeder
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = compare(opts, cfg, mix, fa, pool, sink, done0, done1, b,
                     "cuda" if on_card else "cpu", log)
    result["failed"] = checks["differ"]["value"] * ends
    result["correct"] = all(c["ok"] for c in checks.values())
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def _traced(tmp, rows_path, prof, t_marker, wall0, wall1, reads, result):
    path = os.path.join(tmp, "device.json")
    prof.export_chrome_trace(path)
    window_s = wall1 - t_marker
    intervals = trace.device_intervals(path, t_marker, window_s)
    rows = trace.read_rows(rows_path, wall0, wall1)
    busy = trace.union_seconds(intervals) if intervals is not None else 0.0
    result["device"]["busy_s"] = busy
    result["device"]["window_s"] = window_s
    if intervals is not None:
        result["breakdown"] = trace.breakdown(intervals, rows, t_marker,
                                              t_marker + window_s)
    return Context(rows=rows, reads=reads, window_s=window_s,
                   intervals=intervals, busy_s=busy)


class Context:
    """What a per-layer metric's reader reads (metrics/<name>.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def ms_per_kread(self, pick):
        """Milliseconds of the picked trace rows per thousand reads, or
        None where no row was picked."""
        sec = [r["sec"] for r in self.rows if pick(r)]
        if not sec or not self.reads:
            return None
        return 1e3 * sum(sec) / (self.reads / 1e3)

    def device_ms_per_kread(self, pick):
        """Milliseconds of the device operations whose name is picked,
        per thousand reads, or None where the trace has none."""
        if self.intervals is None or not self.reads:
            return None
        sec = [t - s for name, s, t in self.intervals if pick(name)]
        if not sec:
            return None
        return 1e3 * sum(sec) / (self.reads / 1e3)


def _per_layer(bench, workload, ctx) -> dict:
    """The cell's per-layer metrics its readers find something for."""
    import importlib.util

    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "gpubench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def program_lines(sink, names: set) -> dict:
    """{read name: [its SAM lines in output order]} for `names`."""
    got = {}
    for _, text in sink.writes:
        for line in text.split("\n"):
            if not line or line[0] == "@":
                continue
            q = line[:line.find("\t")]
            if q in names:
                got.setdefault(q, []).append(line)
    return got


def sample(opts, mix, done0, done1, b):
    """The stream units the check compares, drawn from the seed: reads
    done in the window (single ends), or pairs of one chunk done in the
    window (pairs: the chunk is the unit the insert size is inferred
    over)."""
    rng = np.random.default_rng([opts.seed, 0x636B])
    if not mix["paired"]:
        n = min(mix["sample"], done1 - done0)
        return None, np.sort(rng.choice(np.arange(done0, done1), n,
                                        replace=False))
    k = int(rng.integers(-(-done0 // b), done1 // b))
    which = np.sort(rng.choice(b, min(mix["sample"], b), replace=False))
    return k, which


def compare(opts, cfg, mix, fa, pool, sink, done0, done1, b, device, log,
            aligner=None):
    """Compare the program's SAM records of the sample with the
    reference's: the number of reads (pairs) whose records differ, and
    the number compared."""
    from reference.aligner import Aligner

    k, which = sample(opts, mix, done0, done1, b)
    t0 = time.perf_counter()
    al = aligner or Aligner(cfg["mem_args"], fa, device)
    t1 = time.perf_counter()
    n = pool.size
    if k is None:
        g = which
        names = [pool.name(int(x)) for x in g]
        reads = [pool.ends[0][x % n].astype(np.int64) for x in g]
        want = al.align_se(names, reads, [pool.qual * pool.read_len] * len(g))
    else:
        g = k * b + np.arange(b)
        names_all = [pool.name(int(x)) for x in g]
        r1 = [pool.ends[0][x % n].astype(np.int64) for x in g]
        r2 = [pool.ends[1][x % n].astype(np.int64) for x in g]
        q = [pool.qual * pool.read_len] * b
        want = al.align_pe_chunk(names_all, r1, r2, q, q, which)
        names = [names_all[i] for i in which]
    got = program_lines(sink, set(names))
    bad = [(nm, got.get(nm), w) for nm, w in zip(names, want)
           if got.get(nm) != w]
    log(f"[gpubench] reference: index {t1 - t0:.1f} s, {len(names)} "
        f"{'pairs' if k is not None else 'reads'} in "
        f"{time.perf_counter() - t1:.1f} s, {len(bad)} differ")
    for nm, g_, w in bad[:3]:
        log(f"[gpubench] {nm}: program {g_!r:.600}")
        log(f"[gpubench] {nm}: reference {w!r:.600}")
    need = min(mix["sample"], b) if k is not None else mix["sample"]
    return {"differ": {"value": len(bad), "limit": 0, "ok": not bad},
            "compared": {"value": len(names), "limit": need,
                         "ok": len(names) >= need}}
