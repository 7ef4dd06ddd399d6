"""The reference aligner: its suffix sort, and its SAM against the
port's `mem --backend torch` through a whole harness run on the CPU."""

import numpy as np
import pytest

from reference.fmbuild import suffix_array

from _tiny import run_tiny


def test_suffix_array_against_sorting():
    rng = np.random.default_rng(3)
    for s in (rng.integers(0, 4, 3000), np.array([1, 1, 1, 1, 0, 1, 1]),
              np.tile([0, 1, 2], 200), rng.integers(0, 5, 500)):
        s = np.asarray(s, np.uint8)
        want = sorted(range(len(s)), key=lambda i: bytes(s[i:]))
        assert suffix_array(s).tolist() == want


@pytest.mark.parametrize("workload", ["tiny.se", "tiny.pe"])
def test_reference_agrees_with_the_port(workload, tmp_path):
    r = run_tiny(workload, 2 ** 31 + 77, tmp_path)
    assert r["checks"]["compared"]["value"] >= r["checks"]["compared"][
        "limit"] > 0
    assert r["checks"]["differ"]["value"] == 0
    assert r["correct"] is True
    assert r["metrics"]["reads_per_s"]["value"] > 0
