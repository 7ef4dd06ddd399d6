"""The port's batched banded global alignment with traceback
(bwamem_tpu_torch/ops/global_torch.py, the CIGAR second pass) against the
JAX package's (ops/global_jax.py) and the scalar oracle
pipeline/cigar.ksw_global, on the cases of tests/test_global_jax.py; the
round triple of pack_cigar_round; and the resident-reference CIGAR round
(pipeline/resident.cigar_idx_local) against the JAX package's on one meta
block with reverse lanes; the dispatcher of the kernel
(ops/global_cuda.global_batch) on the CPU, and that every device caller of
the port goes through it.  Inputs are made from a seed with numpy; scores
and CIGARs must be equal."""

import ast

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwamem_tpu.config import MemOptions
from bwamem_tpu.ops import global_jax
from bwamem_tpu.pipeline import native_driver as ref_native
from bwamem_tpu.pipeline.cigar import ksw_global
from bwamem_tpu_torch.ops import global_cuda, global_torch
from bwamem_tpu_torch.pipeline import resident

from test_global_jax import _rand_task
from test_torch_local import _port_modules, plain_calls

import _torch_gate as gate

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_matches_jax_and_scalar(seed):
    rng = np.random.default_rng(seed)
    a, b = int(rng.integers(1, 4)), int(rng.integers(1, 6))
    o_del, e_del = int(rng.integers(1, 8)), int(rng.integers(1, 4))
    o_ins, e_ins = int(rng.integers(1, 8)), int(rng.integers(1, 4))
    mat = MemOptions(a=a, b=b).mat
    tasks = [_rand_task(rng) for _ in range(64)]
    got = global_torch.ksw_global_batch(tasks, mat, o_del, e_del, o_ins,
                                        e_ins, CPU)
    assert got == global_jax.ksw_global_batch(tasks, mat, o_del, e_del,
                                              o_ins, e_ins)
    for i, (q, t, w) in enumerate(tasks):
        want = ksw_global(q, t, mat, o_del, e_del, o_ins, e_ins, w,
                          use_native=False)
        assert got[i] == want, (i, q.tolist(), t.tolist(), w, got[i], want)


def test_bwa_defaults_long_reads():
    """bwa -Ma defaults at read scale (150 bp) with indels, and the
    empty-dimension fast paths through the batch wrapper."""
    rng = np.random.default_rng(9)
    opt = MemOptions()
    tasks = []
    for _ in range(16):
        t = rng.integers(0, 4, 150)
        q = t.copy()
        for _ in range(6):
            q[rng.integers(0, 150)] = rng.integers(0, 4)
        if rng.random() < 0.5:
            cut = int(rng.integers(20, 120))
            dl = int(rng.integers(1, 6))
            q = np.concatenate([q[:cut], q[cut + dl:]])
        tasks.append((q.astype(np.int64), t.astype(np.int64), 19))
    tasks.append((np.zeros(0, np.int64), np.array([1, 2]), 10))
    tasks.append((np.array([1, 2]), np.zeros(0, np.int64), 10))
    got = global_torch.ksw_global_batch(tasks, opt.mat, opt.o_del, opt.e_del,
                                        opt.o_ins, opt.e_ins, CPU)
    n_gap = 0
    for i, (q, t, w) in enumerate(tasks):
        want = ksw_global(q, t, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                          opt.e_ins, w, use_native=False)
        assert got[i] == want, (i, got[i], want)
        n_gap += any(op in (1, 2) for op, _ in want[1])
    assert n_gap >= 6


def _round_arrays(rng, Bp, lq, lt, n_live):
    q = rng.integers(0, 5, (Bp, lq)).astype(np.int8)
    t = rng.integers(0, 4, (Bp, lt)).astype(np.int8)
    meta = np.zeros((3, Bp), np.int32)
    meta[0, :n_live] = rng.integers(1, lq + 1, n_live)
    meta[1, :n_live] = rng.integers(1, lt + 1, n_live)
    meta[2, :n_live] = rng.integers(0, 30, n_live)
    for b in range(0, n_live, 2):       # related lanes, one deletion
        n = int(min(meta[0, b], lt - 3))
        meta[0, b] = n
        meta[1, b] = n + 3
        t[b, :n + 3] = np.insert(np.where(q[b, :n] < 4, q[b, :n], 1),
                                 n // 2, [0, 1, 2])
    # padding lanes carry lengths 1 as the host fills them
    meta[0, n_live:] = 1
    meta[1, n_live:] = 1
    return q, t, meta


def test_make_cigar_backend_and_pack_round_match_jax():
    """The shipped-segment round backend: same padded arrays in, the same
    (scores, counts, flat (op, len) pairs) triple out as
    global_jax.make_cigar_backend; pack_cigar_round alone gives the JAX
    package's triple from the same (score, steps)."""
    rng = np.random.default_rng(4)
    opt = MemOptions()
    q, t, meta = _round_arrays(rng, 32, 64, 96, 27)
    args = (q, t, meta, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    got = global_torch.make_cigar_backend(torch.device("cpu"))(*args)
    want = global_jax.make_cigar_backend()(*args)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    assert (got[1][:27:2] >= 3).sum() >= 10     # M D M at the least
    score = rng.integers(-50, 50, 8).astype(np.int32)
    steps = rng.integers(0, 4, (40, 8)).astype(np.int8)
    steps.sort(axis=0)                           # 3 = done comes last
    for g, w in zip(global_torch.pack_cigar_round(torch.from_numpy(score),
                                                  torch.from_numpy(steps)),
                    global_jax.pack_cigar_round(score, steps)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_cigar_idx_local_matches_jax_package():
    """One resident-reference round on the same meta block through both
    packages: forward and reverse lanes (query and reference both walked
    backwards), segments at the text's start, across the strand fold and
    across a 2^20 boundary."""
    rng = np.random.default_rng(6)
    pac = rng.integers(0, 4, (1 << 20) + 997).astype(np.uint8)
    n2 = 2 * len(pac)
    text = ref_native.two_strand_text(pac)
    L2, qmax, tmax, B = 64, 128, 128, 64
    n_live = B - 6
    reads = rng.integers(0, 5, (B, 2 * L2)).astype(np.uint8)
    meta = np.zeros((8, B), np.int32)
    meta[0], meta[1] = 1, 1                       # padding lanes
    pos = rng.integers(tmax, n2 - tmax, B).astype(np.int64)
    pos[:3] = [0, len(pac) - 60, (1 << 20) - 5]
    for b in range(n_live):
        rev = b % 3 == 1 and b >= 3
        qlen = int(rng.integers(10, 2 * L2 - 8))
        tlen = qlen + int(rng.integers(-3, 4))
        qcol0 = int(rng.integers(0, 2 * L2 - qlen))
        p = int(pos[b])
        if rev:
            seg = text[p - tlen + 1:p + 1][::-1]
        else:
            seg = text[p:p + tlen]
        q = np.resize(seg, qlen).astype(np.uint8)
        q[rng.integers(0, qlen, 2)] = rng.integers(0, 4, 2)
        cols = qcol0 + np.arange(qlen)
        if rev:
            qcol0 += qlen - 1
            cols = qcol0 - np.arange(qlen)
        reads[b, cols] = q
        meta[:, b] = (qlen, tlen, int(rng.integers(3, 20)), b, qcol0,
                      int(rev), p & 0xFFFFF, p >> 20)
    meta[6, 5] -= 1 << 20            # the borrow absorbed into lo
    meta[7, 5] += 1
    nib = (reads[:, 0::2] | (reads[:, 1::2] << 4)).astype(np.int8)
    opt = MemOptions()
    pens = np.array([opt.o_del, opt.e_del, opt.o_ins, opt.e_ins], np.int32)
    w_score, w_steps = ref_native.cigar_idx_local(
        jnp.asarray(nib), jnp.asarray(meta),
        jnp.asarray(opt.mat.astype(np.int32)), jnp.asarray(pens),
        ref_native.make_resident_text(pac), qmax=qmax, tmax=tmax)
    g_score, g_steps = resident.cigar_idx_local(
        torch.from_numpy(nib), torch.from_numpy(meta),
        torch.from_numpy(opt.mat.astype(np.int32)), torch.from_numpy(pens),
        resident.make_resident_text(pac, "cpu"), qmax=qmax, tmax=tmax)
    assert np.array_equal(g_score.numpy(), np.asarray(w_score))
    assert np.array_equal(g_steps.numpy(), np.asarray(w_steps))
    assert meta[5, :n_live].sum() >= 10
    # related segments: the score is near the match count
    assert (np.asarray(w_score)[:n_live] > meta[0, :n_live] - 40).all()
    cig = global_torch.rle_cigars(g_steps.numpy())
    assert any(op in (1, 2) for c in cig[:n_live] for op, _ in c)


@pytest.mark.parametrize("arbitrary", [True, False],
                         ids=["arbitrary_matrix", "bwa_matrix"])
def test_dispatcher_on_cpu_is_the_plain_version(arbitrary):
    """global_cuda.global_batch on CPU tensors == global_torch.global_batch
    == global_jax._global_batch on the hard-case batch of
    tests/_torch_gate.py, and counts no launch."""
    args = gate.global_sw_batch(9, 48, 64, 96, arbitrary=arbitrary)
    t = [torch.from_numpy(a) for a in args]
    before = dict(global_cuda.launches)
    score, steps = global_cuda.global_batch(*t)
    assert global_cuda.launches == before
    assert score.dtype == torch.int32 and steps.dtype == torch.int8
    assert steps.shape == (64 + 96, 48)
    ws, wst = global_torch.global_batch(*t)
    assert torch.equal(score, ws) and torch.equal(steps, wst)
    js, jst = global_jax._global_batch(*(jnp.asarray(a) for a in args),
                                       qmax=64, tmax=96)
    assert np.array_equal(score.numpy(), np.asarray(js))
    assert np.array_equal(steps.numpy(), np.asarray(jst))
    assert (steps.numpy() == 1).any(0).sum() >= 3
    assert (steps.numpy() == 2).any(0).sum() >= 3


def test_device_callers_go_through_the_dispatcher():
    """No module of the port but ops/global_cuda.py calls the plain
    global_torch.global_batch: the resident and shipped CIGAR backends,
    their sharded twins and ksw_global_batch (the Python host's
    --device-cigar) reach the kernel through global_cuda.global_batch."""
    assert plain_calls("global_torch", ("global_batch",), "global_cuda",
                       {}) == []
    users = {rel for rel, tree in _port_modules() for node in ast.walk(tree)
             if isinstance(node, (ast.ImportFrom, ast.Attribute))
             and "global_cuda" in ast.dump(node)}
    for rel in ("pipeline/resident.py", "parallel/dist.py",
                "ops/global_torch.py"):
        assert rel in users, rel
