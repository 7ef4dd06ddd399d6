"""The port's batched local Smith-Waterman (bwamem_tpu_torch/ops/
local_torch.py, mate-rescue compute) against the JAX package's
(ops/local_jax.py) and the scalar oracle ops/local_ref.ksw_align, on the
cases of tests/test_local_jax.py (random matrices and penalties, ties,
N codes, empty tasks), and the resident-reference rescue wave
(pipeline/resident.rescue_idx_local) against the JAX package's on one
meta block with reverse lanes and window edges; the dispatcher of the
kernel (ops/local_cuda.align6) on the CPU, and that every device caller
of the port goes through it.  Inputs are made from a seed with numpy;
every value is an integer and must be equal."""

import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwamem_tpu.config import MemOptions
from bwamem_tpu.ops import local_jax
from bwamem_tpu.ops.local_ref import ksw_align
from bwamem_tpu.pipeline import native_driver as ref_native
from bwamem_tpu_torch.ops import local_cuda, local_torch
from bwamem_tpu_torch.pipeline import resident

from test_local_jax import _rand_task

import _torch_gate as gate

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _random_scoring(rng):
    a, b = int(rng.integers(1, 4)), int(rng.integers(1, 6))
    return (MemOptions(a=a, b=b).mat, int(rng.integers(1, 8)),
            int(rng.integers(1, 4)), int(rng.integers(1, 8)),
            int(rng.integers(1, 4)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_matches_jax_and_scalar(seed):
    rng = np.random.default_rng(seed)
    mat, o_del, e_del, o_ins, e_ins = _random_scoring(rng)
    tasks = [_rand_task(rng) for _ in range(64)]
    got = local_torch.ksw_align_batch(tasks, mat, o_del, e_del, o_ins, e_ins,
                                      CPU)
    assert got == local_jax.ksw_align_batch(tasks, mat, o_del, e_del, o_ins,
                                            e_ins)
    for i, (q, t) in enumerate(tasks):
        want = ksw_align(q, t, mat, o_del, e_del, o_ins, e_ins,
                         use_native=False)
        assert got[i] == want, (i, q.tolist(), t.tolist(), got[i], want)


def test_arbitrary_matrix_and_ties():
    """A 5x5 matrix that is not bwa-style (every entry its own value), and
    tasks built to tie: a query of one repeated unit against a target of
    several copies, where many cells share the best score, so the first
    row and the leftmost column decide."""
    rng = np.random.default_rng(11)
    mat = rng.integers(-6, 5, (5, 5)).astype(np.int8)
    mat[np.arange(4), np.arange(4)] = rng.integers(1, 4, 4)
    tasks = []
    for k in range(24):
        unit = rng.integers(0, 4, int(rng.integers(2, 6)))
        q = np.resize(unit, int(rng.integers(4, 20)))
        t = np.resize(unit, int(rng.integers(20, 60)))
        if k % 3 == 0:
            t[rng.integers(0, len(t))] = 4
        tasks.append((q.astype(np.int64), t.astype(np.int64)))
    got = local_torch.ksw_align_batch(tasks, mat, 3, 1, 2, 2, CPU)
    assert got == local_jax.ksw_align_batch(tasks, mat, 3, 1, 2, 2)
    ties = 0
    for i, (q, t) in enumerate(tasks):
        want = ksw_align(q, t, mat, 3, 1, 2, 2, use_native=False)
        assert got[i] == want, (i, got[i], want)
        ties += want[0] > 0 and want[4] < len(t) - len(q)
    assert ties >= 8   # the best cell recurs further down the target


def test_rescue_scale_defaults():
    """Mate-rescue shapes at bwa defaults: a 150 bp mate against a ~500 bp
    insert window, plus the empty-task fast path."""
    rng = np.random.default_rng(7)
    opt = MemOptions()
    tasks = []
    for _ in range(16):
        t = rng.integers(0, 4, 500)
        p = int(rng.integers(0, 350))
        q = t[p:p + 150].copy()
        for _ in range(4):
            q[rng.integers(0, 150)] = rng.integers(0, 4)
        tasks.append((q.astype(np.int64), t.astype(np.int64)))
    tasks.append((np.zeros(0, np.int64), np.array([1, 2])))
    got = local_torch.ksw_align_batch(tasks, opt.mat, opt.o_del, opt.e_del,
                                      opt.o_ins, opt.e_ins, CPU)
    for i, (q, t) in enumerate(tasks):
        want = ksw_align(q, t, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins, use_native=False)
        assert got[i] == want, (i, got[i], want)


def test_make_rescue_backend_matches_jax_backend():
    """The shipped-window wave backend: same padded int8 arrays in, same
    (6, Bp) int32 rows out as local_jax.make_rescue_backend, padding lanes
    (lengths 0) included."""
    rng = np.random.default_rng(3)
    opt = MemOptions()
    Bp, lq, lt = 32, 64, 128
    seq = rng.integers(0, 5, (Bp, lq)).astype(np.int8)
    rseq = rng.integers(0, 4, (Bp, lt)).astype(np.int8)
    lens = np.zeros((2, Bp), np.int32)
    lens[0, :27] = rng.integers(1, lq + 1, 27)
    lens[1, :27] = rng.integers(1, lt + 1, 27)
    for b in range(0, 27, 2):       # related lanes
        n = lens[0, b]
        p = int(rng.integers(0, lt - n + 1))
        rseq[b, p:p + n] = np.where(seq[b, :n] < 4, seq[b, :n], 0)
    args = (seq, rseq, lens, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins)
    got = local_torch.make_rescue_backend(torch.device("cpu"))(*args)
    want = local_jax.make_rescue_backend()(*args)
    assert got.dtype == np.int32 and got.shape == (6, Bp)
    assert np.array_equal(got, want)
    assert (got[0] > 0).sum() >= 14


def test_rescue_idx_local_matches_jax_package():
    """One resident-reference wave on the same meta block through both
    packages: forward and reverse lanes (in-lane reverse complement, N
    kept), windows at position 0, across the strand fold, across a 2^20
    boundary with the borrow absorbed into lo, and at the text's end."""
    rng = np.random.default_rng(5)
    pac = rng.integers(0, 5, (1 << 20) + 997).astype(np.uint8)
    n2 = 2 * len(pac)
    L2, qmax, tmax, B = 64, 128, 512, 64
    n_live = B - 5
    text = ref_native.two_strand_text(pac)
    reads = rng.integers(0, 5, (B, 2 * L2)).astype(np.uint8)
    meta = np.zeros((6, B), np.int32)
    meta[0, :n_live] = rng.integers(20, 2 * L2 + 1, n_live)
    meta[1, :n_live] = rng.integers(1, tmax + 1, n_live)
    meta[2, :n_live] = rng.permutation(B)[:n_live]
    meta[3, :n_live] = rng.integers(0, 2, n_live)
    pos = rng.integers(0, n2 - tmax, B).astype(np.int64)
    pos[:4] = [0, len(pac) - 100, (1 << 20) - 7, n2 - tmax]
    for b in range(0, n_live, 2):
        # a related lane: the mate, as the lane reads it, is a copy of a
        # stretch of its window with two substitutions
        n = int(meta[0, b])
        meta[1, b] = tmax
        p0 = int(pos[b]) + int(rng.integers(0, tmax - n))
        q = text[p0:p0 + n].astype(np.uint8)
        q[rng.integers(0, n, 2)] = rng.integers(0, 4, 2)
        if meta[3, b]:
            q = np.where(q[::-1] < 4, 3 - q[::-1], q[::-1])
        reads[meta[2, b], :n] = q
    nib = (reads[:, 0::2] | (reads[:, 1::2] << 4)).astype(np.int8)
    meta[4], meta[5] = pos & 0xFFFFF, pos >> 20
    meta[4, 4] -= 1 << 20            # the borrow absorbed into lo
    meta[5, 4] += 1
    opt = MemOptions()
    pens = np.array([opt.o_del, opt.e_del, opt.o_ins, opt.e_ins], np.int32)
    want = np.asarray(ref_native.rescue_idx_local(
        jnp.asarray(nib), jnp.asarray(meta),
        jnp.asarray(opt.mat.astype(np.int32)), jnp.asarray(pens),
        ref_native.make_resident_text(pac), qmax=qmax, tmax=tmax))
    got = resident.rescue_idx_local(
        torch.from_numpy(nib), torch.from_numpy(meta),
        torch.from_numpy(opt.mat.astype(np.int32)), torch.from_numpy(pens),
        resident.make_resident_text(pac, "cpu"), qmax=qmax, tmax=tmax)
    assert got.dtype == torch.int32 and got.shape == (6, B)
    assert np.array_equal(got.numpy(), want)
    assert meta[3, :n_live].min() == 0 and meta[3, :n_live].max() == 1
    assert (want[0, n_live:] == 0).all()
    # the related lanes found their copy (the text is a fifth N)
    assert np.median(want[0, :n_live:2]) > 2 * np.median(want[0, 1:n_live:2])


@pytest.mark.parametrize("arbitrary", [True, False],
                         ids=["arbitrary_matrix", "bwa_matrix"])
def test_dispatcher_on_cpu_is_the_plain_version(arbitrary):
    """local_cuda.align6 on CPU tensors == local_torch.align6 ==
    local_jax._align6 on the hard-case batch of tests/_torch_gate.py, and
    counts no launch (only a kernel launch counts)."""
    args = gate.local_sw_batch(8, 48, 64, 160, arbitrary=arbitrary)
    t = [torch.from_numpy(a) for a in args]
    before = dict(local_cuda.launches)
    got = local_cuda.align6(*t)
    assert local_cuda.launches == before
    assert got.dtype == torch.int32 and got.shape == (6, 48)
    assert torch.equal(got, local_torch.align6(*t))
    want = np.asarray(local_jax._align6(*(jnp.asarray(a) for a in args),
                                        qmax=64, tmax=160))
    assert np.array_equal(got.numpy(), want)
    assert (want[0] > 0).sum() >= 30 and (want[:, -3:] == 0).all()


def _port_modules():
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bwamem_tpu_torch")
    for d, _, names in os.walk(root):
        for n in sorted(names):
            if n.endswith(".py"):
                path = os.path.join(d, n)
                with open(path) as f:
                    yield os.path.relpath(path, root), ast.parse(f.read())


def plain_calls(plain_mod, names, dispatcher, owner_calls):
    """(file, line, what) of every use of the plain functions `names` of
    ops/`plain_mod`.py outside the dispatcher ops/`dispatcher`.py: an
    import of them, an attribute `plain_mod.name`, or inside the plain
    module a call by name other than those `owner_calls` allows
    ({function: names it may call}: the plain version's own parts)."""
    bad = []
    for rel, tree in _port_modules():
        if rel == os.path.join("ops", dispatcher + ".py"):
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.endswith("ops." + plain_mod)):
                bad += [(rel, node.lineno, a.name) for a in node.names
                        if a.name in names]
            elif (isinstance(node, ast.Attribute) and node.attr in names
                  and getattr(node.value, "id", "") == plain_mod):
                bad.append((rel, node.lineno, f"{plain_mod}.{node.attr}"))
        if rel != os.path.join("ops", plain_mod + ".py"):
            continue
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and getattr(node.func, "id", "") in names
                        and node.func.id not in owner_calls.get(fn.name, ())):
                    bad.append((rel, node.lineno, f"{fn.name} calls "
                                f"{node.func.id}"))
    return bad


def test_device_callers_go_through_the_dispatcher():
    """No module of the port but ops/local_cuda.py calls the plain
    local_torch.align6 / fill: the resident and shipped rescue backends,
    their sharded twins and ksw_align_batch reach the kernel through
    local_cuda.align6 (align6 itself runs fill twice: that is the plain
    version)."""
    assert plain_calls("local_torch", ("align6", "fill"), "local_cuda",
                       {"align6": ("fill",)}) == []
    users = {rel for rel, tree in _port_modules() for node in ast.walk(tree)
             if isinstance(node, (ast.ImportFrom, ast.Attribute))
             and "local_cuda" in ast.dump(node)}
    for rel in ("pipeline/resident.py", "parallel/dist.py",
                "ops/local_torch.py"):
        assert rel in users, rel
