"""The benchmark's own tests (not collected by the repository's suite):

    python -m pytest gpubench/tests -q

Tests marked `cuda` need an NVIDIA GPU and skip without one; on the card
the same command runs them."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch

    # the port's plain backend runs two chunks at once: keep their
    # intra-op threads from crowding a small machine
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (torch.cuda); skips without")
