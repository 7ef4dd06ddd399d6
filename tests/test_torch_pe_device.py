"""The device halves of the paired-end protocols through the port's
NativePipeline on the CPU (plain PyTorch): mate-rescue waves
(mp_rescue_*, `--device-rescue`) and CIGAR rounds (mp_cigar_*,
`--device-cigar`), with host-shipped windows and from the resident
reference, and the 16-bit cell extension on the resident path.  The
counterparts of tests/test_native_pipe.py's device-rescue, device-CIGAR
and text-path tests: each SAM must equal, byte for byte, the all-C++ run
(host rescue, host CIGAR) and the JAX package's device run on the same
reads, and a counting wrapper shows that a wave or a round really
fired."""

import numpy as np
import pytest
import torch

from bwamem_tpu.config import MemOptions
from bwamem_tpu.ops import global_jax, local_jax
from bwamem_tpu.pipeline import native_driver as ref_native
from bwamem_tpu.pipeline.align import revcomp_read
from bwamem_tpu_torch.ops import extend_cuda, global_torch, local_torch, types
from bwamem_tpu_torch.pipeline import native_driver, resident

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


def _counting(fn, arg):
    """fn wrapped to note the shape of positional argument `arg` of every
    call; keeps fn's .idx."""
    calls = []

    def wrapped(*a):
        calls.append(a[arg].shape)
        return fn(*a)

    if getattr(fn, "idx", False):
        wrapped.idx = True
    return wrapped, calls


def _ext(opt, pac):
    """The port's resident fused extension backend on the CPU."""
    return resident.make_fused_idx_backend(
        types.params_from_options(opt), pac, CPU, blk_l=BLK)


def _port(opt, world, reads, pe, **kw):
    ref, fm, po, _ = world
    pipe = native_driver.NativePipeline(opt, ref, fm, po, nthreads=2,
                                        blk_l=BLK)
    run = pipe.align_pairs_chunk if pe else pipe.align_chunk
    return _lines(run(*reads, _ext(opt, ref.pac), **kw))


def _jax(opt, world, reads, pe, **kw):
    """The JAX package's NativePipeline with its device backends (the
    extension through the extend_jax twin)."""
    ref, fm, po, _ = world
    pipe = ref_native.NativePipeline(opt, ref, fm, po, nthreads=2)
    run = pipe.align_pairs_chunk if pe else pipe.align_chunk
    return _lines(run(*reads, ref_native.make_jax_raw_t_backend(
        _jax_params(opt)), **kw))


def _rescue_backends(world, idx):
    ref = world[0]
    if idx:
        return (resident.make_rescue_idx_backend(ref.pac, CPU),
                ref_native.make_rescue_idx_backend(ref.pac))
    return (local_torch.make_rescue_backend(CPU),
            local_jax.make_rescue_backend())


def _cigar_backends(world, idx):
    ref = world[0]
    if idx:
        return (resident.make_cigar_idx_backend(ref.pac, CPU),
                ref_native.make_cigar_idx_backend(ref.pac))
    return (global_torch.make_cigar_backend(CPU),
            global_jax.make_cigar_backend())


def _rescue_pairs(world, n, every):
    """_pe_reads plus a few same-strand (discordant) mates: their
    proper-FR window is untrained for that pair, so rescue fires beyond
    the mutated and all-N mates already there."""
    ref, _, _, _ = world
    r1s, r2s = _pe_reads(np.random.default_rng(n), ref, n)
    for i in range(0, n, every):
        r2s[i] = revcomp_read(r2s[i])
    return r1s, r2s


@pytest.mark.parametrize("idx", [False, True], ids=["shipped", "idx"])
def test_pe_device_rescue_sam_identical(world, idx):
    opt = MemOptions()
    reads = _rescue_pairs(world, 40, 7)
    host = _port(opt, world, reads, True)
    got_fn, jax_fn = _rescue_backends(world, idx)
    got_fn, calls = _counting(got_fn, 1 if idx else 0)
    got = _port(opt, world, reads, True, rescue_fn=got_fn)
    assert calls, "no rescue wave fired: vacuous comparison"
    assert got == host
    assert got == _jax(opt, world, reads, True, rescue_fn=jax_fn)


@pytest.mark.parametrize("idx", [False, True], ids=["shipped", "idx"])
def test_se_device_cigar_sam_identical(world, idx):
    opt = MemOptions()
    ref = world[0]
    reads, names, quals = make_reads(np.random.default_rng(48), ref, 48)
    kw = dict(names=names, quals=quals)
    host = _port(opt, world, (reads,), False, **kw)
    got_fn, jax_fn = _cigar_backends(world, idx)
    got_fn, calls = _counting(got_fn, 1 if idx else 0)
    got = _port(opt, world, (reads,), False, cigar_fn=got_fn, **kw)
    assert calls, "no CIGAR round fired: vacuous comparison"
    assert got == host
    assert got == _jax(opt, world, (reads,), False, cigar_fn=jax_fn, **kw)
    cigars = [l.split("\t")[5] for rr in got for l in rr]
    assert any("I" in c for c in cigars) and any("D" in c for c in cigars)


def test_se_device_cigar_flag_a(world):
    """Device CIGAR rounds under -a (every passing region emitted)."""
    opt = MemOptions(flag_a=True)
    ref = world[0]
    reads, names, quals = make_reads(np.random.default_rng(24), ref, 24)
    kw = dict(names=names, quals=quals)
    got_fn, calls = _counting(global_torch.make_cigar_backend(CPU), 0)
    got = _port(opt, world, (reads,), False, cigar_fn=got_fn, **kw)
    assert calls
    assert got == _port(opt, world, (reads,), False, **kw)
    assert got == _jax(opt, world, (reads,), False,
                       cigar_fn=global_jax.make_cigar_backend(), **kw)


@pytest.mark.parametrize("idx", [False, True], ids=["shipped", "idx"])
def test_pe_device_cigar_and_rescue_sam_identical(world, idx):
    """PE with both device protocols (waves, then rounds over the
    candidate superset): both must fire."""
    opt = MemOptions()
    reads = _rescue_pairs(world, 36, 9)
    host = _port(opt, world, reads, True)
    r_fn, r_jax = _rescue_backends(world, idx)
    c_fn, c_jax = _cigar_backends(world, idx)
    r_fn, rcalls = _counting(r_fn, 1 if idx else 0)
    c_fn, ccalls = _counting(c_fn, 1 if idx else 0)
    got = _port(opt, world, reads, True, rescue_fn=r_fn, cigar_fn=c_fn)
    assert rcalls and ccalls, (rcalls, ccalls)
    assert got == host
    assert got == _jax(opt, world, reads, True, rescue_fn=r_jax,
                       cigar_fn=c_jax)


@pytest.mark.parametrize("idx", [False, True], ids=["shipped", "idx"])
def test_pe_device_cigar_only_sam_identical(world, idx):
    """cigar_fn without rescue_fn: rescue stays host C++ and only the
    sam_pe globals go to the device."""
    opt = MemOptions()
    ref = world[0]
    reads = _pe_reads(np.random.default_rng(25), ref, 24)
    c_fn, c_jax = _cigar_backends(world, idx)
    c_fn, calls = _counting(c_fn, 1 if idx else 0)
    got = _port(opt, world, reads, True, cigar_fn=c_fn)
    assert calls
    assert got == _port(opt, world, reads, True)
    assert got == _jax(opt, world, reads, True, cigar_fn=c_jax)


@pytest.mark.parametrize("what", ["rescue", "cigar"])
def test_pe_text_with_idx_backends(world, what):
    """The zero-object PE text path composed with the resident-reference
    device rescue or device CIGAR == the per-record path, byte for byte,
    with the protocol firing, all three idx backends sharing one text."""
    opt = MemOptions()
    ref, fm, po, _ = world
    r1s, r2s = _rescue_pairs(world, 30, 6)
    text_dev = resident.make_resident_text(ref.pac, CPU)
    ext = resident.make_fused_idx_backend(
        types.params_from_options(opt), None, CPU, blk_l=BLK,
        text_dev=text_dev)
    make = (resident.make_rescue_idx_backend if what == "rescue"
            else resident.make_cigar_idx_backend)
    fn, calls = _counting(make(None, CPU, text_dev=text_dev), 1)
    kw = {f"{what}_fn": fn}
    want = native_driver.NativePipeline(
        opt, ref, fm, po, blk_l=BLK).align_pairs_chunk(r1s, r2s, ext, **kw)
    n_first = len(calls)
    text, nrec = native_driver.NativePipeline(
        opt, ref, fm, po, blk_l=BLK).align_pairs_chunk_text(r1s, r2s, ext,
                                                            **kw)
    assert n_first and len(calls) == 2 * n_first
    assert text == "".join(r.line() + "\n" for rr in want for r in rr)
    assert nrec == sum(len(rr) for rr in want)
    assert _lines(want) == _port(opt, world, (r1s, r2s), True)


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_i16_resident_backend_sam_identical(world, pe):
    """NativePipeline with the 16-bit cell resident backend: SAM equal to
    the 32-bit one; on the CPU it runs the plain 16-bit version and counts
    no kernel launch."""
    opt = MemOptions()
    ref, fm, po, _ = world
    rng = np.random.default_rng(32)
    if pe:
        reads, kw = _pe_reads(rng, ref, 18), {}
    else:
        r, names, quals = make_reads(rng, ref, 32)
        reads, kw = (r,), dict(names=names, quals=quals)
    fn16 = resident.make_fused_idx_backend(
        types.params_from_options(opt), ref.pac, CPU, blk_l=BLK,
        compute_dtype=torch.int16)
    pipe = native_driver.NativePipeline(opt, ref, fm, po, blk_l=BLK)
    run = pipe.align_pairs_chunk if pe else pipe.align_chunk
    extend_cuda.reset_launches()
    got = _lines(run(*reads, fn16, **kw))
    assert fn16.dispatches == 1 and not any(extend_cuda.launches.values())
    assert got == _port(opt, world, reads, pe, **kw)


def test_i16_resident_backend_refuses_long_reads(world):
    """The resident factory knows the score bound a_max * read length (the
    quantity that gates the int16 D2H) and refuses 16-bit cells where it
    reaches 2^14."""
    ref = world[0]
    opt = MemOptions(a=127, b=4)
    fn = resident.make_fused_idx_backend(
        types.params_from_options(opt), ref.pac, CPU, blk_l=BLK,
        compute_dtype=torch.int16)
    nib = np.zeros((256, 80), np.int8)          # reads of 160 bases
    with pytest.raises(ValueError, match="2\\^14"):
        fn(nib, np.zeros((16, BLK), np.int32), None, (32, 32, 32, 32))
