"""The check fails what it must: a run with the timed path broken
underneath comes out not correct, and so does the control (the reference
with the clipping penalty dropped) against the reference."""

import json
import os
import sys

import pytest

from harness import cell

from _tiny import DATA, run_tiny


class _Broken:
    """sys.stdout for the aligner that breaks its output the way `fault`
    says, then passes it on."""

    def __init__(self, out, fault):
        self.out, self.fault = out, fault

    def write(self, text):
        lines = text.split("\n")
        recs = [i for i, ln in enumerate(lines) if ln and ln[0] != "@"]
        if recs and self.fault == "altered":
            for i in recs[::4]:                  # POS moved by one
                f = lines[i].split("\t")
                f[3] = str(int(f[3]) + 1)
                lines[i] = "\t".join(f)
        elif recs and self.fault == "half_left_out":
            keep = set(recs[1::2]) | {recs[-1]}
            lines = [ln for i, ln in enumerate(lines)
                     if i in keep or i not in recs]
        return self.out.write("\n".join(lines))

    def flush(self):
        pass


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_broken_output_is_not_correct(fault, tmp_path, monkeypatch):
    real = cell.cli()

    class Cli:
        @staticmethod
        def main(argv):
            if argv[0] == "mem":
                sys.stdout = _Broken(sys.stdout, fault)
            return real.main(argv)

    monkeypatch.setattr(cell, "cli", lambda: Cli)
    r = run_tiny("tiny.se", 2 ** 31 + 5, tmp_path)
    assert r["checks"]["differ"]["value"] > 0
    assert r["correct"] is False


@pytest.mark.parametrize("traffic", ["tiny_se", "tiny_pe"])
def test_control_is_not_correct(traffic, tmp_path):
    from control import control_differ

    with open(os.path.join(DATA, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(DATA, "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    fa = cell.prepare(cfg, str(tmp_path), log=lambda m: None)
    res = control_differ(cfg, dict(mix, sample=64), fa, [11, 12, 13],
                         "cpu", log=lambda m: None)
    assert all(d > 0 for _, d, _ in res), res
