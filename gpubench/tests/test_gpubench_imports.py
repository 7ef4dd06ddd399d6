"""Nothing under gpubench/ imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names are
compared whole (bwamem_tpu_torch is not bwamem_tpu)."""

import ast
import os

from _tiny import ROOT

BENCH = os.path.join(ROOT, "gpubench")
BARRED = {"jax", "jaxlib", "flax", "bwamem_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _files(BENCH):
        assert not (set(_imports(path)) & BARRED), path


def test_reference_takes_nothing_of_the_port():
    for path in _files(os.path.join(BENCH, "reference")):
        assert "bwamem_tpu_torch" not in set(_imports(path)), path


def test_names_are_compared_whole():
    from harness.cell import barred_modules
    import sys

    sys.modules.setdefault("bwamem_tpu_torch_probe", object())
    try:
        assert "bwamem_tpu_torch_probe" not in barred_modules()
    finally:
        del sys.modules["bwamem_tpu_torch_probe"]
