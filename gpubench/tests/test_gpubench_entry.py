"""The command's refusals, and one short run on the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from _tiny import ROOT

CMD = [sys.executable, "gpubench/run.py", "--workload", "ecoli_k12.pe150",
       "--seed", "2147483659", "--seconds", "5", "--trace", "0"]


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()


def test_no_result_without_a_card():
    if _cuda():
        pytest.skip("a card is present")
    p = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not _cuda():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
