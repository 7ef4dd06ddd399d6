#!/usr/bin/env python3
"""The control of the comparison that decides `correct`.

The check compares the program's SAM records of a sample drawn from the
seed with the reference aligner's, exactly (limit: 0 reads or pairs
differ).  The control puts the reference itself in the program's place
with one guarantee of the configuration broken: the clipping penalty of
bwa's defaults (`-L 5`) dropped to 0, which is what an extension that
ignores its end-to-end score (`gscore`) gives: the step a faster
extension kernel would be tempted by.  The control must come out not
correct on every seed:

    python3 gpubench/control.py --workload grch38_chr20.pe150 \
        --seeds 11,12,13

It builds the cell's genome and index as a run does, draws each seed's
sample as a run draws it from a window of `WINDOW_CHUNKS` chunks, aligns
it with the reference as configured and as the control, and prints one
line a seed: how many differ, and how many were compared.
"""

import argparse
import copy
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WINDOW_CHUNKS = 64
CONTROL_ARGS = ["-L", "0"]


def control_differ(cfg, mix, fa, seeds, device, log=print):
    """[(seed, differ, compared)] of the control against the reference."""
    import numpy as np

    from harness.cell import chunk_size, sample
    from harness.genome import read_fasta_codes
    from harness.reads import make_pool
    from reference.aligner import Aligner, options

    b = chunk_size(cfg["mem_args"])
    warm = mix["warmup_chunks"] * b
    genome = read_fasta_codes(fa)
    t0 = time.perf_counter()
    ref = Aligner(cfg["mem_args"], fa, device)
    ctl = copy.copy(ref)
    ctl.opt = options(cfg["mem_args"] + CONTROL_ARGS)
    log(f"[control] reference index {time.perf_counter() - t0:.1f} s")
    out = []
    for seed in seeds:
        pool = make_pool(genome, mix, seed)
        k, which = sample(types.SimpleNamespace(seed=seed), mix, warm,
                          warm + WINDOW_CHUNKS * b, b)
        n = pool.size
        q = [pool.qual * pool.read_len]
        if k is None:
            names = [pool.name(int(x)) for x in which]
            reads = [pool.ends[0][x % n].astype(np.int64) for x in which]
            got = [al.align_se(names, reads, q * len(names))
                   for al in (ref, ctl)]
        else:
            g = k * b + np.arange(b)
            names = [pool.name(int(x)) for x in g]
            r1 = [pool.ends[0][x % n].astype(np.int64) for x in g]
            r2 = [pool.ends[1][x % n].astype(np.int64) for x in g]
            got = [al.align_pe_chunk(names, r1, r2, q * b, q * b, which)
                   for al in (ref, ctl)]
        differ = sum(a != c for a, c in zip(*got))
        out.append((seed, differ, len(got[0])))
        log(f"[control] seed {seed}: {differ} of {len(got[0])} differ "
            f"(limit 0)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    opts = ap.parse_args()
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness.cell import load_cell, prepare

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _, cfg, mix = load_cell(bench, opts.workload)
    fa = prepare(cfg)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    res = control_differ(cfg, mix, fa,
                         [int(s) for s in opts.seeds.split(",")], device)
    print(json.dumps({"workload": opts.workload, "control": [
        {"seed": s, "differ": d, "compared": c} for s, d, c in res]}))
    return 0 if all(d > 0 for _, d, _ in res) else 1


if __name__ == "__main__":
    sys.exit(main())
