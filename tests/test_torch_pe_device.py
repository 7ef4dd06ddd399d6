"""The device halves of the paired-end protocols through the port's
NativePipeline on the CPU (plain PyTorch): the mate-rescue batch and
its replay (mp_rescue_*, `--device-rescue`) and CIGAR rounds (mp_cigar_*,
`--device-cigar`), with host-shipped windows and from the resident
reference, and the 16-bit cell extension on the resident path.  The
counterparts of tests/test_native_pipe.py's device-rescue, device-CIGAR
and text-path tests: each SAM must equal, byte for byte, the all-C++ run
(host rescue, host CIGAR) and the JAX package's device run on the same
reads, and a counting wrapper shows that a batch or a round really
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


# -- the speculative rescue batch and its replay ---------------------------

REP_L = 60000
REP_TANDEM = 20000                      # 3 x a 60 bp unit: anchors 60 apart
REP_COPIES = (5000, 12000, 30000, 38000, 46000, 53000)   # a 100 bp family


def _mutated(rng, m):
    """Substituted every 9 bases: no 19-mer seeds, so only rescue places
    it (tests/test_torch_pipeline.py _pe_reads, kind 2)."""
    m = m.copy()
    for p in range(4, len(m), 9):
        m[p] = (m[p] + 1 + rng.integers(0, 3)) % 4
    return m


@pytest.fixture(scope="module")
def repeat_world():
    """A 60 kb contig with a tandem array and a dispersed 100 bp family,
    and a chunk of pairs: 48 plain FR pairs (insert 300 +- 30) for the
    insert-size statistics; three whose first end lies in the tandem
    array, so its anchors sit 60 bases apart and the mate an earlier
    anchor rescues lies in a later anchor's window (the superset holds
    tasks the replay drops); and two whose first end is the family,
    with an anchor at each of its copies.  Every mate of these five is
    substituted every 9 bases."""
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.index.occ_packed import pack_occ
    from bwamem_tpu.io.fasta import Contig, Reference

    rng = np.random.default_rng(7)
    pac = rng.integers(0, 4, REP_L).astype(np.uint8)
    pac[REP_TANDEM:REP_TANDEM + 180] = np.tile(
        rng.integers(0, 4, 60).astype(np.uint8), 3)
    fam = rng.integers(0, 4, 100).astype(np.uint8)
    for c in REP_COPIES:
        pac[c:c + 100] = fam
    ref = Reference(contigs=[Contig("chrA", 0, REP_L)], pac=pac)
    fm = build_index(pac)
    world = (ref, fm, pack_occ(fm), None)

    def seg(a, b):
        return pac[a:b].astype(np.int64)

    away = [(REP_TANDEM - 400, REP_TANDEM + 600)] + [
        (c - 400, c + 500) for c in REP_COPIES]
    r1s, r2s = [], []
    while len(r1s) < 48:
        pos = int(rng.integers(0, REP_L - 500))
        if any(a <= pos <= b for a, b in away):
            continue
        isize = 300 + int(rng.integers(-30, 30))
        r1s.append(seg(pos, pos + 100))
        r2s.append(revcomp_read(seg(pos + isize - 100, pos + isize)))
    for d in (0, 5, 10):
        p, isize = REP_TANDEM + d, 300 + d
        r1s.append(seg(p, p + 100))
        r2s.append(revcomp_read(_mutated(rng, seg(p + isize - 100,
                                                  p + isize))))
    for c in REP_COPIES[:2]:
        r1s.append(seg(c, c + 100))
        r2s.append(revcomp_read(_mutated(rng, seg(c + 200, c + 300))))
    return world, (r1s, r2s)


def _traced(opt, world, reads, **kw):
    """_port's PE run with a counters-only tracer: (SAM lines, counters)."""
    from bwamem_tpu_torch.utils.metrics import Tracer

    ref, fm, po, _ = world
    tr = Tracer(None)
    pipe = native_driver.NativePipeline(opt, ref, fm, po, nthreads=2,
                                        blk_l=BLK, tracer=tr)
    return _lines(pipe.align_pairs_chunk(*reads, _ext(opt, ref.pac),
                                         **kw)), tr.counters


@pytest.mark.parametrize("idx", [False, True], ids=["shipped", "idx"])
def test_pe_device_rescue_replay_drops_speculative_tasks(repeat_world,
                                                         idx):
    """A later anchor's window holds the region an earlier anchor's rescue
    appended: the speculative batch computes tasks that bwa's sequential
    loop skips, and the replay must drop them.  The SAM equals host
    rescue (mp_finalize_pe, and mp_rescue_host under device CIGARs) and
    the JAX package's wave protocol, byte for byte."""
    world, reads = repeat_world
    opt = MemOptions()
    got_fn, jax_fn = _rescue_backends(world, idx)
    got_fn, calls = _counting(got_fn, 1 if idx else 0)
    got, ctr = _traced(opt, world, reads, rescue_fn=got_fn)
    assert ctr.rescue_tasks > ctr.rescue_used > 0, ctr
    assert len(calls) == 1
    assert got == _port(opt, world, reads, True)
    assert got == _port(opt, world, reads, True,
                        cigar_fn=global_torch.make_cigar_backend(CPU))
    assert got == _jax(opt, world, reads, True, rescue_fn=jax_fn)


def test_pe_device_rescue_one_call_a_chunk(repeat_world):
    """Ends with five or more anchors within pen_unpaired of their best
    (a record each, every one of score 100) make one rescue_fn call a
    chunk, not one per anchor rank."""
    world, reads = repeat_world
    opt = MemOptions()
    fn, calls = _counting(resident.make_rescue_idx_backend(
        world[0].pac, CPU), 1)
    got, ctr = _traced(opt, world, reads, rescue_fn=fn)
    family = [[l for l in rr if int(l.split("\t")[1]) & 0x40]
              for rr in got[-2:]]
    assert all(len(f) >= 5 for f in family), family
    assert all(l.endswith("AS:i:100") for f in family for l in f)
    assert calls == [(6, 256)] and ctr.device_batches == 2, ctr


@pytest.mark.parametrize("idx", [False, True], ids=["shipped", "idx"])
def test_pe_device_rescue_lane_cap_splits_batches(repeat_world, idx,
                                                  monkeypatch):
    """With the lane cap below the superset, the batches split it into
    several calls and the SAM and the counters stay those of one call."""
    world, reads = repeat_world
    opt = MemOptions()
    fn = _rescue_backends(world, idx)[0]
    one, ctr1 = _traced(opt, world, reads, rescue_fn=fn)
    monkeypatch.setattr(native_driver, "RESCUE_LANES", 4)
    fn, calls = _counting(fn, 1 if idx else 0)
    split, ctr = _traced(opt, world, reads, rescue_fn=fn)
    assert len(calls) == -(-ctr1.rescue_tasks // 4) > 1
    assert split == one
    assert (ctr.rescue_tasks, ctr.rescue_used) == (ctr1.rescue_tasks,
                                                   ctr1.rescue_used)
