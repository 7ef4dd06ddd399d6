"""A tiny cell for the CPU tests: a 200 kb genome with repeats, the
port on its plain PyTorch backend, chunks of 32 reads."""

import json
import os
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"] = [
        {"name": "tiny.se", "config": "tiny", "traffic": "tiny_se",
         "chips": 1, "why": "CPU test"},
        {"name": "tiny.pe", "config": "tiny", "traffic": "tiny_pe",
         "chips": 1, "why": "CPU test"}]
    return b


def run_tiny(workload, seed, cache, seconds=15.0, max_units=192):
    from harness.cell import run

    opts = types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=0)
    return run(opts, bench(), data_dir=DATA, cache=str(cache),
               t_start=time.perf_counter(), require_cuda=False,
               max_units=max_units, log=lambda m: None)
