#!/usr/bin/env python3
"""End-to-end align rates of the four paths of bwamem_tpu_torch at 8x the
size of chip_smoke.py's run, on a machine with one NVIDIA GPU:

    python3 chip_rates.py

It simulates chip_smoke.py's genome with 262,144 single-end reads and
65,536 FR pairs, builds the index, and runs `mem --backend cuda -b 2048
--inflight 3 -t min(cores, 8)` with tracing off through the native
paths in turns (resident, --phased, --ship-ref, --ship-ref, --phased,
resident), SE then PE, and once through `--host python` on the first
16,384 reads and 8,192 pairs.  It prints each run's `[mem] align:` line
(the whole-loop and the steady rate) and checks nothing: chip_smoke.py
holds the paths' output.

    python3 chip_rates.py --profile

runs instead chip_smoke.py's 32,768 single-end reads once through each
native path under torch.profiler and prints the wall, the device time
(all kernels and copies), the extension kernel's share of it and its
launches.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

SCALE = 8
PY_SE, PY_PE = 16_384, 8_192


def profile(cs, common, fa, se) -> None:
    """One profiled SE run per native path."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    with prof(activities=[ProfilerActivity.CUDA]):   # the tracer's start-up
        torch.zeros(1, device="cuda").sum().item()
    for name, flags in (("resident", []), ("--phased", ["--phased"]),
                        ("--ship-ref", ["--ship-ref"])):
        t0 = time.time()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            cs.run_cli(["mem", *common, *flags, fa, se], os.devnull)
            torch.cuda.synchronize()
        wall = time.time() - t0
        rows = [(e.key, dev_us(e), e.count) for e in p.key_averages()
                if dev_us(e) > 0]
        total = sum(us for _, us, _ in rows)
        kern = [(k, us, n) for k, us, n in rows if "extend_" in k]
        top = sorted(rows, key=lambda r: -r[1])[:6]
        print(f"profile {name}: wall {wall:.3f} s (mem with the profiler "
              f"on), device time {total / 1e3:.3f} ms = "
              f"{100 * total / 1e6 / wall:.2f}% busy; extension kernels "
              f"{[(k[:40], round(us / 1e3, 3), n) for k, us, n in kern]}; "
              f"top {[(k[:40], round(us / 1e3, 3), n) for k, us, n in top]}",
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_rates.py needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    profiling = "--profile" in sys.argv[1:]
    scale = 1 if profiling else SCALE
    tmp = tempfile.mkdtemp(prefix="bwamem_rates_")
    try:
        fa, se, pe1, pe2 = cs.simulate(tmp, scale * cs.N_SE,
                                         scale * cs.N_PE)
        cs.run_cli(["index", fa], os.devnull)
        common = ["--backend", "cuda", "-b", "2048", "--inflight", "3",
                  "-t", str(min(os.cpu_count() or 1, 8))]

        def rate(tag, flags, reads):
            text = cs.run_cli(["mem", *common, *flags, fa, *reads],
                              os.devnull)
            line = re.search(r"\[mem\] align: .*", text).group(0)
            print(f"{tag}: {line}", flush=True)

        # one untimed chunk first: the kernels and the host library build
        rate("warm-up", [], [cs.head_fastq(se, os.path.join(tmp, "w.fq"),
                                           2048)])
        if profiling:
            profile(cs, common, fa, se)
            return 0
        turns = [("resident", []), ("--phased", ["--phased"]),
                 ("--ship-ref", ["--ship-ref"])]
        for ends, reads in (("SE", [se]), ("PE", [pe1, pe2])):
            for name, flags in turns + turns[::-1]:
                rate(f"{ends} {name}", flags, reads)
        sub_se = [cs.head_fastq(se, os.path.join(tmp, "se_py.fq"), PY_SE)]
        sub_pe = [cs.head_fastq(pe1, os.path.join(tmp, "p1_py.fq"), PY_PE),
                  cs.head_fastq(pe2, os.path.join(tmp, "p2_py.fq"), PY_PE)]
        for ends, reads in (("SE", sub_se), ("PE", sub_pe)):
            rate(f"{ends} --host python ({PY_SE} reads / {PY_PE} pairs)",
                 ["--host", "python"], reads)
            rate(f"{ends} resident on the same files", [], reads)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
