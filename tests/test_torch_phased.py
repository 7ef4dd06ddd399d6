"""The port's host-shipped-window backends and its Python host against
the JAX package's, on the CPU (plain PyTorch):

- the four-pass protocol: NativePipeline driving the port's
  make_raw_t_backend == the reference's (Pallas `_extend_kernel_t` in
  interpret mode) == the port's resident-reference fused backend;
- --ship-ref: the port's make_fused_backend == the reference's;
- the Python host: the port's driver.align_batch / pair.align_pairs with
  ops.extend.make_raw_backend == the reference's with the extend_jax
  twin (tests/test_native_pipe.py `_compare` and
  `test_pe_native_regions_identical`).

SAM is compared byte for byte."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax

from bwamem_tpu.config import MemOptions
from bwamem_tpu.ops.extend_jax import extend_batch_core
from bwamem_tpu.pipeline import driver as ref_driver
from bwamem_tpu.pipeline import native_driver as ref_native
from bwamem_tpu.pipeline import pair as ref_pair
from bwamem_tpu_torch.ops import extend, types
from bwamem_tpu_torch.pipeline import driver, native_driver, pair, resident

import _torch_gate as gate
from test_torch_pipeline import (  # noqa: F401 (world: a fixture)
    _jax_params,
    _pe_reads,
    make_reads,
    world,
)

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native library unavailable")

torch.set_num_threads(1)

BLK = 128
CPU = torch.device("cpu")


def _lines(recs):
    return [[r.line() for r in rr] for rr in recs]


def _params(opt):
    jp = _jax_params(opt)
    return jp, types.params_from_jax(jp)


def _native(opt, world, fn, reads, pe=False, **kw):
    ref, fm, po, _ = world
    pipe = ref_native.NativePipeline(opt, ref, fm, po, blk_l=BLK)
    if pe:
        return _lines(pipe.align_pairs_chunk(*reads, fn))
    return _lines(pipe.align_chunk(reads, fn, **kw))


@pytest.mark.parametrize("pe", [False, True], ids=["SE", "PE"])
def test_phased_sam_identical(world, pe):
    """The four-pass protocol through the port == through the reference's
    Pallas per-phase backend == the port's fused resident path."""
    opt = MemOptions()
    ref, _, _, rng = world
    jp, p = _params(opt)
    if pe:
        reads, kw = _pe_reads(rng, ref, 18), {}
    else:
        reads, names, quals = make_reads(rng, ref, 32)
        kw = dict(names=names, quals=quals)
    got_fn = native_driver.make_raw_t_backend(p, CPU, blk_l=BLK)
    want = _native(opt, world, ref_native.make_raw_t_backend(
        jp, blk_l=BLK, interpret=True), reads, pe, **kw)
    got = _native(opt, world, got_fn, reads, pe, **kw)
    fused = _native(opt, world, resident.make_fused_idx_backend(
        p, ref.pac, CPU, blk_l=BLK), reads, pe, **kw)
    assert want == got == fused
    assert got_fn.dispatches >= 2  # at least L0 and R0


@pytest.mark.parametrize("pe", [False, True], ids=["SE", "PE"])
def test_ship_ref_sam_identical(world, pe):
    """--ship-ref: the host-filled windows through the port's fused
    backend == through the reference's (Pallas, interpret mode)."""
    opt = MemOptions()
    ref, _, _, rng = world
    jp, p = _params(opt)
    if pe:
        reads, kw = _pe_reads(rng, ref, 18), {}
    else:
        reads, names, quals = make_reads(rng, ref, 32)
        kw = dict(names=names, quals=quals)
    got_fn = native_driver.make_fused_backend(p, CPU, blk_l=BLK)
    assert got_fn.fused and not hasattr(got_fn, "idx")
    want = _native(opt, world, ref_native.make_fused_backend(
        jp, blk_l=BLK, interpret=True), reads, pe, **kw)
    assert _native(opt, world, got_fn, reads, pe, **kw) == want
    assert got_fn.dispatches == 1


def _jax_twin(opt):
    jp = _jax_params(opt)
    return jax.jit(lambda *a: extend_batch_core(*a, jp))


@pytest.mark.parametrize("opt", [MemOptions(), MemOptions(flag_a=False),
                                 MemOptions(flag_M=False)],
                         ids=["defaults", "no_a", "no_M"])
def test_python_host_align_batch_identical(world, opt):
    """The port's align_batch with make_raw_backend on the CPU == the
    reference's align_batch with the extend_jax twin."""
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 40)
    want = ref_driver.align_batch(opt, ref, fm, reads, _jax_twin(opt),
                                  names=names, quals=quals, po=po)
    got = driver.align_batch(
        opt, ref, fm, reads,
        extend.make_raw_backend(_params(opt)[1], CPU, blk_l=BLK),
        names=names, quals=quals, po=po)
    assert _lines(got) == _lines(want)


def test_python_host_align_pairs_identical(world):
    """The port's align_pairs with make_raw_backend on the CPU == the
    reference's with the extend_jax twin, and its scalar branch is the
    reference's."""
    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_reads(rng, ref, 16)
    want = ref_pair.align_pairs(opt, ref, fm, r1s, r2s, po=po,
                                extend_batch_fn=_jax_twin(opt))
    got = pair.align_pairs(
        opt, ref, fm, r1s, r2s, po=po,
        extend_batch_fn=extend.make_raw_backend(_params(opt)[1], CPU,
                                                blk_l=BLK))
    assert _lines(got) == _lines(want)
    # no extend_batch_fn: the scalar host, which gives the same records
    assert _lines(pair.align_pairs(opt, ref, fm, r1s, r2s, po=po)) == \
        _lines(want)


def test_python_host_refuses_device_cigar(world, monkeypatch):
    """The Python host no longer refuses `device_cigar` (the name is from
    when it did): align_batch(device_cigar=True) runs the reg2aln global
    realignments through ops/global_torch and gives the SAM of the
    reference's align_batch(device_cigar=True) and of the host CIGAR
    path, with at least one batched round of real tasks."""
    from bwamem_tpu_torch.ops import global_torch

    opt = MemOptions()
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 30)
    fn = extend.make_raw_backend(_params(opt)[1], CPU, blk_l=BLK)
    host = driver.align_batch(opt, ref, fm, reads, fn, names=names,
                              quals=quals, po=po)
    rounds = []
    real = global_torch.ksw_global_batch

    def counting(tasks, *a, **kw):
        rounds.append(len(tasks))
        return real(tasks, *a, **kw)

    monkeypatch.setattr(global_torch, "ksw_global_batch", counting)
    with pytest.raises(ValueError, match="device="):
        driver.align_batch(opt, ref, fm, reads, fn, names=names,
                           quals=quals, po=po, device_cigar=True)
    got = driver.align_batch(opt, ref, fm, reads, fn, names=names,
                             quals=quals, po=po, device_cigar=True,
                             device=CPU)
    assert rounds and max(rounds) > 0, "no CIGAR round fired"
    want = ref_driver.align_batch(opt, ref, fm, reads, _jax_twin(opt),
                                  names=names, quals=quals, po=po,
                                  device_cigar=True)
    assert _lines(got) == _lines(want) == _lines(host)
    assert any("I" in r.line().split("\t")[5] or "D" in r.line().split(
        "\t")[5] for rr in got for r in rr)


def test_raw_t_backend_concurrent_calls():
    """`--inflight N` calls the per-phase backend from N threads at once:
    every call is counted and every result equals the single-threaded
    one."""
    q, t, scal, tmax = gate.random_t_batch(8, BLK, 32, 48, blk_l=BLK)
    fn = native_driver.make_raw_t_backend(
        types.params_from_options(MemOptions()), CPU, blk_l=BLK)
    want = fn(q, t, scal, tmax)
    assert isinstance(want, np.ndarray) and want.shape == (8, BLK)
    n_threads = 16
    got = [None] * n_threads

    def call(k):
        got[k] = fn(q, t, scal, tmax)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=call, args=(k,))
              for k in range(n_threads)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ts)
    assert fn.dispatches == n_threads + 1
    assert all(np.array_equal(g, want) for g in got)
