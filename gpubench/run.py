#!/usr/bin/env python3
"""The benchmark of bwamem_tpu_torch `mem` on an NVIDIA GPU.

    python3 gpubench/run.py --workload ecoli_k12.pe150 --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout.  The cell (a configuration under a
traffic mix) is named in BENCHMARK.json; its files are found by name in
gpubench/configs/ and gpubench/traffic/, its per-layer metrics in
gpubench/metrics/.  `--trace 0` prints the cell's end-to-end metrics,
`--trace 1` its per-layer metrics, the device's busy time and a
breakdown.  The numbers compared with the reference aligner are the last
lines on standard error and the `checks` of the result line; the result
line is the last line on standard output.  Without a CUDA device (or
with fewer than the cell asks for) it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args()
    sys.path[:0] = [HERE, ROOT]
    from harness.cell import RunError, run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    try:
        result = run(opts, bench, t_start=T_START)
    except RunError as e:
        print(f"[gpubench] no result: {e}", file=sys.stderr, flush=True)
        # the aligner's threads may still run: end them with the process
        os._exit(2)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
