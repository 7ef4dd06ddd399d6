"""The port's plain extensions (bwamem_tpu_torch/ops/extend_torch.py:
the fused four-pass and the per-phase one-pass) against the JAX
package's Pallas kernels in interpret mode
(extend_pallas.extend_batch_raw_fused, extend_batch_raw_t) and the
scalar bwa-0.7.8 oracle (extend_ref.ksw_extend_core), and the port's
host half (ops/extend.py) against extend_pallas's.  Inputs are made
from a seed with numpy; tolerance is exact — every output is an
integer — on every row and lane, padding lanes and lanes that did not
retry included.  The 16-bit cell versions (compute_dtype=torch.int16)
are held the same way to the Pallas kernels at compute_dtype=jnp.int16
in interpret mode, to the port's own 32-bit plain version and to the
scalar oracle, inside the range the wrapper states, and the wrapper's
refusals outside it."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwamem_tpu.config import build_mat
from bwamem_tpu.ops import extend_pallas
from bwamem_tpu.ops.extend_ref import ksw_extend_core
from bwamem_tpu.ops.extend_jax import ExtendParams
from bwamem_tpu_torch.ops import extend, extend_cuda, extend_torch, types

import _torch_gate as gate

torch.set_num_threads(1)

BLK = 128


def _prm(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100):
    return np.array([a, b, o_del, e_del, o_ins, e_ins, zdrop, 0], np.int32)


def _pallas(batch, prm, dt=jnp.int32):
    ql, tl, qr, tr, scal, tmax2 = batch
    return np.asarray(extend_pallas.extend_batch_raw_fused(
        *(jnp.asarray(x.astype(np.int32)) for x in (ql, tl, qr, tr)),
        jnp.asarray(scal), jnp.asarray(tmax2), jnp.asarray(prm),
        blk_l=BLK, interpret=True, compute_dtype=dt))


def _plain(batch, prm, dt=torch.int32):
    out = extend_cuda.extend_batch_raw_fused(
        *(torch.from_numpy(x) for x in batch), prm, compute_dtype=dt)
    assert out.dtype == torch.int32 and out.shape == (32, batch[4].shape[1])
    return out.numpy()


def _retry_counts(out, scal):
    thr = (scal[9] >> 1) + (scal[9] >> 2)
    live_l = (scal[0] > 0) & (scal[1] > 0) & (scal[3] > 0)
    live_r = (scal[5] > 0) & (scal[6] > 0)
    return (int((live_l & (out[5] >= thr)).sum()),
            int((live_l & (out[5] < thr)).sum()),
            int((live_r & (out[21] >= thr)).sum()))


@pytest.mark.parametrize("pen", [(1, 4, 6, 1, 6, 1), (1, 4, 5, 2, 7, 3),
                                 (2, 3, 2, 1, 2, 1)])
@pytest.mark.parametrize("zdrop", [100, 0])
def test_fused_matches_pallas(pen, zdrop):
    """Penalty grid x zdrop on/off; N codes, padding lanes, lanes with
    no left or right task and both retry outcomes in every batch."""
    seed = sum(pen) * 7 + zdrop
    batch = gate.random_fused_batch(seed, 2 * BLK, (48, 96, 48, 96),
                                    n_pad=21, blk_l=BLK)
    prm = _prm(*pen, zdrop=zdrop)
    want = _pallas(batch, prm)
    got = _plain(batch, prm)
    bad = np.argwhere(got != want)
    assert bad.size == 0, (bad[:8], got[tuple(bad[0])], want[tuple(bad[0])])
    n_retry_l, n_conv_l, n_retry_r = _retry_counts(want, batch[4])
    assert n_retry_l + n_retry_r > 0 and n_conv_l > 0
    assert (batch[0] == 4).any() and (batch[1] == 4).any()  # N codes


def test_fused_matches_pallas_full_width_query():
    """QL = QR = 1024, the kernel's widest query window, with lanes at
    qlen == qmax (the window has no row `end`)."""
    batch = gate.random_fused_batch(3, BLK, (1024, 40, 1024, 48),
                                    n_pad=5, blk_l=BLK)
    assert (batch[4][0] == 1024).any() and (batch[4][5] == 1024).any()
    prm = _prm()
    assert np.array_equal(_plain(batch, prm), _pallas(batch, prm))


def test_fused_l0_matches_scalar_oracle():
    """The L0 group of the plain version == ksw_extend_core lane by lane
    (the on-card gate of chip_smoke.py, here on the CPU)."""
    batch = gate.random_fused_batch(9, BLK, (96, 160, 96, 160), blk_l=BLK)
    prm = _prm()
    out = _plain(batch, prm)
    lanes = gate.valid_l0_lanes(batch[4])[:96]
    assert len(lanes) == 96
    assert gate.l0_scalar_mismatches(out, batch[0], batch[1], batch[4],
                                     prm, lanes) == []


@pytest.mark.parametrize("seed,pen", [(0, (6, 1, 6, 1)), (1, (5, 2, 7, 3)),
                                      (2, (2, 1, 2, 1))])
def test_band_pass_matches_ksw_extend_core(seed, pen):
    """One pass of band_pass == ksw_extend_core on every valid lane, at
    narrow, wide and mixed bands, zdrop on."""
    o_del, e_del, o_ins, e_ins = pen
    rng = np.random.default_rng(seed)
    B, QM, TM = 48, 80, 120
    q = rng.integers(0, 5, (QM, B)).astype(np.int8)
    t = rng.integers(0, 5, (TM, B)).astype(np.int8)
    t[:QM, ::2] = q[:, ::2]                      # related half
    qlen = rng.integers(1, QM + 1, B).astype(np.int32)
    tlen = rng.integers(1, TM + 1, B).astype(np.int32)
    aw = np.concatenate([np.full(16, 7), np.full(16, 100),
                         rng.integers(0, 101, 16)]).astype(np.int32)
    h0 = rng.integers(1, 80, B).astype(np.int32)
    zdrop = 40
    prm = np.array([1, 4, o_del, e_del, o_ins, e_ins, zdrop, 0], np.int32)
    res = extend_torch.band_pass(
        torch.from_numpy(t), torch.from_numpy(q), torch.from_numpy(qlen),
        torch.from_numpy(tlen), torch.from_numpy(aw), torch.from_numpy(h0),
        prm)
    got = np.stack([r.numpy() for r in res])
    mat = build_mat(1, 4)
    for i in range(B):
        want = ksw_extend_core(q[:qlen[i], i].astype(np.int64),
                               t[:tlen[i], i].astype(np.int64), mat,
                               o_del, e_del, o_ins, e_ins, w=int(aw[i]),
                               h0=int(h0[i]), zdrop=zdrop)
        assert tuple(int(x) for x in got[:, i]) == (
            want.score, want.qle - 1, want.tle - 1, want.gtle - 1,
            want.gscore, want.max_off), i


def test_cuda_path_refuses_non_cuda_devices():
    """The wrappers take the plain path only for CPU tensors."""
    batch = gate.random_fused_batch(0, BLK, (16, 16, 16, 16), blk_l=BLK)
    meta = [torch.from_numpy(x).to("meta") for x in batch]
    with pytest.raises(ValueError):
        extend_cuda.extend_batch_raw_fused(*meta, _prm())
    batch = gate.random_t_batch(0, BLK, 16, 16, blk_l=BLK)
    meta = [torch.from_numpy(x).to("meta") for x in batch]
    with pytest.raises(ValueError):
        extend_cuda.extend_batch_raw_t(*meta, _prm())


def test_kernel_prm_refuses_scores_outside_a_signed_byte():
    """The kernels keep a row's substitution scores as signed bytes."""
    assert extend_cuda.kernel_prm(_prm(a=127, b=127)) == [127, 127, 6, 1, 6,
                                                          1, 100]
    for bad in (_prm(a=128), _prm(b=128), _prm(a=-1)):
        with pytest.raises(ValueError):
            extend_cuda.kernel_prm(bad)


def _pallas_t(batch, prm, dt=jnp.int32):
    q, t, scal, tmax = batch
    return np.asarray(extend_pallas.extend_batch_raw_t(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(t.astype(np.int32)),
        jnp.asarray(scal), jnp.asarray(tmax), prm=jnp.asarray(prm),
        blk_l=BLK, interpret=True, compute_dtype=dt))


def _plain_t(batch, prm, dt=torch.int32):
    out = extend_cuda.extend_batch_raw_t(
        *(torch.from_numpy(x) for x in batch), prm, compute_dtype=dt)
    assert out.dtype == torch.int32 and out.shape == (8, batch[2].shape[1])
    return out.numpy()


@pytest.mark.parametrize("pen", [(1, 4, 6, 1, 6, 1), (1, 4, 5, 2, 7, 3),
                                 (2, 3, 2, 1, 2, 1)])
@pytest.mark.parametrize("zdrop", [100, 0])
def test_extend_t_matches_pallas(pen, zdrop):
    """Plain extend_t == _extend_kernel_t on all 8 rows and every lane:
    penalty grid x zdrop on/off; N codes, padding lanes and lanes with
    qlen, tlen or h0 of 0 in every batch."""
    batch = gate.random_t_batch(sum(pen) * 5 + zdrop, 2 * BLK, 48, 96,
                                n_pad=19, blk_l=BLK)
    prm = _prm(*pen, zdrop=zdrop)
    want = _pallas_t(batch, prm)
    got = _plain_t(batch, prm)
    bad = np.argwhere(got != want)
    assert bad.size == 0, (bad[:8], got[tuple(bad[0])], want[tuple(bad[0])])
    scal = batch[2]
    live = (scal[0] > 0) & (scal[1] > 0) & (scal[3] > 0)
    assert live.any() and (~live[:-19]).any() and (batch[0] == 4).any()


def test_extend_t_matches_pallas_full_width_query():
    """qmax = 1024, the widest query window, with lanes at qlen == qmax."""
    batch = gate.random_t_batch(4, BLK, 1024, 40, n_pad=3, blk_l=BLK)
    assert (batch[2][0] == 1024).any()
    prm = _prm()
    assert np.array_equal(_plain_t(batch, prm), _pallas_t(batch, prm))


def test_extend_t_matches_scalar_oracle():
    """Fields 0-5 of the plain extend_t == ksw_extend_core lane by lane
    (the on-card gate of chip_smoke.py, here on the CPU)."""
    batch = gate.random_t_batch(10, BLK, 96, 160, blk_l=BLK)
    prm = _prm()
    out = _plain_t(batch, prm)
    lanes = gate.valid_l0_lanes(batch[2])[:96]
    assert len(lanes) == 96
    assert gate.l0_scalar_mismatches(out, batch[0], batch[1], batch[2],
                                     prm, lanes) == []


def test_extend_t_at_the_capacity_limits():
    """The reference hardware's caps (tests/test_extend_pallas.py:130):
    qlen 255, tlen 2047, B = 8.  The plain extend_t == _extend_kernel_t
    in interpret mode on all 8 rows and every lane, and fields 0-5 ==
    ksw_extend_core on every lane."""
    batch = gate.capacity_t_batch()
    q, t, scal, tmax = batch
    prm = _prm()
    got = _plain_t(batch, prm)
    want = np.asarray(extend_pallas.extend_batch_raw_t(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(t.astype(np.int32)),
        jnp.asarray(scal), jnp.asarray(tmax), prm=jnp.asarray(prm),
        blk_l=8, interpret=True))
    assert np.array_equal(got, want)
    n, bad = _oracle_mismatches(got, q, t, scal, prm)
    assert n == 8 and bad == []
    assert (got[0] >= 255 + 100).all()      # the whole query matched


def _tasks(seed, B, qmax, tmax):
    """B row-major tasks (query (B, qmax), target (B, tmax) int32) with
    their lengths, bands, h0 and gap bounds; the last 7 are padding."""
    rng = np.random.default_rng(seed)
    q, t, qlen, tlen = gate._task(rng, B, qmax, tmax,
                                  rng.integers(4, 40, B))
    qlen[-7:] = 0
    w = rng.integers(4, 60, B).astype(np.int32)
    h0 = rng.integers(1, 50, B).astype(np.int32)
    max_ins = rng.integers(10, 120, B).astype(np.int32)
    max_del = rng.integers(10, 120, B).astype(np.int32)
    return (q.T.astype(np.int32), qlen, t.T.astype(np.int32), tlen, w, h0,
            max_ins, max_del)


@pytest.mark.parametrize("with_prev", [False, True])
def test_extend_batch_matches_jax_package(with_prev):
    """The port's extend_batch and pack_scal == extend_pallas's
    (interpret mode) on every ExtendOut field, w_used included."""
    q, qlen, t, tlen, w, h0, max_ins, max_del = _tasks(6, 2 * BLK, 40, 80)
    prev = (np.random.default_rng(1).integers(-1, 60, 2 * BLK)
            .astype(np.int32) if with_prev else None)
    jp = ExtendParams(mat_flat=jnp.asarray(build_mat(1, 4).astype(
        np.int32).ravel()), m=5, o_del=6, e_del=1, o_ins=6, e_ins=1,
        zdrop=100)
    want = extend_pallas.extend_batch(
        q, qlen, t, tlen, w, h0, max_ins, max_del, jp,
        prev_score=None if prev is None else jnp.asarray(prev),
        blk_b=BLK, interpret=True)
    got = extend.extend_batch(q, qlen, t, tlen, w, h0, max_ins, max_del,
                              types.params_from_jax(jp), prev_score=prev,
                              blk_b=BLK, device="cpu")
    assert isinstance(got, types.ExtendOut)
    for f in types.ExtendOut._fields:
        g = getattr(got, f)
        assert isinstance(g, np.ndarray), f
        assert np.array_equal(g, np.asarray(getattr(want, f))), f
    for a, b in zip(extend.pack_scal(qlen, tlen, w, h0, blk_b=BLK),
                    extend_pallas.pack_scal(qlen, tlen, w, h0, blk_b=BLK)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fn", ["extend_batch", "extend_batch_core"])
def test_extend_batch_defaults_to_the_card(fn):
    """Called without device=, the per-phase helpers ask for the card:
    where there is none they raise device.resolve's RuntimeError, and do
    not quietly run the plain version on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    q, qlen, t, tlen, w, h0, max_ins, max_del = _tasks(6, BLK, 40, 80)
    prm = types.params_from_jax(ExtendParams(
        mat_flat=jnp.asarray(build_mat(1, 4).astype(np.int32).ravel()), m=5,
        o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100))
    args = ((q, qlen, t, tlen, w, h0, max_ins, max_del, prm)
            if fn == "extend_batch" else (q, qlen, t, tlen, w, h0, prm))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        getattr(extend, fn)(*args, blk_b=BLK)


def _oracle_mismatches(out, q, t, scal, prm):
    """Fields 0-5 of `out` against the JAX package's ksw_extend_core on
    every lane it can run (qlen, tlen, h0 > 0 in scal rows 0, 1, 3; band
    in row 2); target rows past the window re-read its last row."""
    a, b, o_del, e_del, o_ins, e_ins, zdrop = (int(x) for x in prm[:7])
    mat = build_mat(a, b)
    bad = []
    lanes = gate.valid_l0_lanes(scal)
    for i in lanes:
        rows = np.minimum(np.arange(scal[1, i]), t.shape[0] - 1)
        want = ksw_extend_core(q[:scal[0, i], i].astype(np.int64),
                               t[rows, i].astype(np.int64), mat, o_del,
                               e_del, o_ins, e_ins, w=int(scal[2, i]),
                               h0=int(scal[3, i]), zdrop=zdrop)
        got = tuple(int(out[f, i]) for f in range(6))
        if got != (want.score, want.qle, want.tle, want.gtle, want.gscore,
                   want.max_off):
            bad.append((int(i), got, want))
    return len(lanes), bad


@pytest.mark.parametrize("qmax,zdrop", [(33, 100), (33, 0), (160, 100),
                                        (160, 0), (300, 100), (300, 0),
                                        (1024, 100)])
def test_extend_t_hard_cases_match_pallas_and_oracle(qmax, zdrop):
    """The hard-case batch (strip edges, long gaps, ties, trims, Z-drop,
    tlen past the window, N, empty lanes): plain extend_t ==
    _extend_kernel_t in interpret mode on all 8 rows of every lane, and
    == the JAX package's ksw_extend_core on every lane it can run."""
    batch = gate.hard_t_batch(5, qmax, blk_l=BLK)
    q, t, scal, _ = batch
    assert {n for n in gate.HARD_QLENS if n <= qmax} <= set(scal[0].tolist())
    assert set(gate.HARD_AWS) <= set(scal[2].tolist())
    assert (scal[1] > t.shape[0]).any() or qmax < 100   # tlen > tmax
    prm = _prm(zdrop=zdrop)
    got = _plain_t(batch, prm)
    want = _pallas_t(batch, prm)
    bad = np.argwhere(got != want)
    assert bad.size == 0, (bad[:8], got[tuple(bad[0])], want[tuple(bad[0])])
    n, bad = _oracle_mismatches(got, q, t, scal, prm)
    assert n >= 27 and bad == [], bad[:3]
    if zdrop == 0 and qmax >= 100:      # the Z-drop stop is in the batch
        assert (got != _plain_t(batch, _prm(zdrop=100))).any()


@pytest.mark.parametrize("qmax,zdrop", [(33, 100), (160, 100), (160, 0),
                                        (300, 100), (1024, 100)])
def test_fused_hard_cases_match_pallas_and_oracle(qmax, zdrop):
    """The hard cases as a fused batch (every case seeded with the left
    score of an unrelated one, the long gaps through the retry): plain
    extend_fused == _extend_kernel_fused in interpret mode on all 32
    rows of every lane, and its L0 group == the JAX package's
    ksw_extend_core."""
    batch = gate.hard_fused_batch(11, qmax, blk_l=BLK)
    prm = _prm(zdrop=zdrop)
    got = _plain(batch, prm)
    want = _pallas(batch, prm)
    bad = np.argwhere(got != want)
    assert bad.size == 0, (bad[:8], got[tuple(bad[0])], want[tuple(bad[0])])
    n_retry_l, _, n_retry_r = _retry_counts(want, batch[4])
    assert qmax < 100 or (n_retry_l > 0 and n_retry_r > 0)
    n, bad = _oracle_mismatches(got, batch[0], batch[1], batch[4], prm)
    assert n >= 27 and bad == [], bad[:3]


# ---- 16-bit cells --------------------------------------------------------


def _all_equal(*outs):
    for o in outs[1:]:
        bad = np.argwhere(o != outs[0])
        assert bad.size == 0, (bad[:8], o[tuple(bad[0])],
                               outs[0][tuple(bad[0])])


@pytest.mark.parametrize("pen", [(1, 4, 6, 1, 6, 1), (1, 4, 5, 2, 7, 3),
                                 (2, 3, 2, 1, 2, 1)])
@pytest.mark.parametrize("zdrop", [100, 0])
def test_i16_gate_batches_match_pallas_i16_and_i32(pen, zdrop):
    """The gate batches with 16-bit cells: plain extend_t and extend_fused
    == the Pallas kernels at compute_dtype=jnp.int16 (interpret mode) ==
    the port's 32-bit plain version, on every row and lane."""
    prm = _prm(*pen, zdrop=zdrop)
    batch = gate.random_t_batch(sum(pen) * 5 + zdrop, 2 * BLK, 48, 96,
                                n_pad=19, blk_l=BLK)
    _all_equal(_plain_t(batch, prm, torch.int16),
               _pallas_t(batch, prm, jnp.int16), _plain_t(batch, prm))
    batch = gate.random_fused_batch(sum(pen) * 7 + zdrop, 2 * BLK,
                                    (48, 96, 48, 96), n_pad=21, blk_l=BLK)
    got = _plain(batch, prm, torch.int16)
    _all_equal(got, _pallas(batch, prm, jnp.int16), _plain(batch, prm))
    n_retry_l, n_conv_l, n_retry_r = _retry_counts(got, batch[4])
    assert n_retry_l + n_retry_r > 0 and n_conv_l > 0


@pytest.mark.parametrize("qmax,zdrop", [(33, 100), (33, 0), (160, 100),
                                        (160, 0), (300, 100), (300, 0)])
def test_i16_extend_t_hard_cases(qmax, zdrop):
    """The hard-case batch in the query windows inside the 16-bit range:
    plain 16-bit extend_t == the Pallas kernel at jnp.int16 == the 32-bit
    plain version on all 8 rows, and == ksw_extend_core."""
    batch = gate.hard_t_batch(5, qmax, blk_l=BLK)
    prm = _prm(zdrop=zdrop)
    got = _plain_t(batch, prm, torch.int16)
    _all_equal(got, _pallas_t(batch, prm, jnp.int16), _plain_t(batch, prm))
    n, bad = _oracle_mismatches(got, batch[0], batch[1], batch[2], prm)
    assert n >= 27 and bad == [], bad[:3]


@pytest.mark.parametrize("qmax,zdrop", [(33, 100), (160, 100), (160, 0),
                                        (300, 100)])
def test_i16_fused_hard_cases(qmax, zdrop):
    batch = gate.hard_fused_batch(11, qmax, blk_l=BLK)
    prm = _prm(zdrop=zdrop)
    got = _plain(batch, prm, torch.int16)
    _all_equal(got, _pallas(batch, prm, jnp.int16), _plain(batch, prm))
    n, bad = _oracle_mismatches(got, batch[0], batch[1], batch[4], prm)
    assert n >= 27 and bad == [], bad[:3]


def _edge_batch(qmax, h0):
    """Lanes whose target starts with the query itself, so the score
    climbs to h0 + a*qmax."""
    rng = np.random.default_rng(2)
    q = rng.integers(0, 4, (qmax, BLK)).astype(np.int8)
    t = np.concatenate([q, rng.integers(0, 4, (32, BLK)).astype(np.int8)])
    scal = np.zeros((8, BLK), np.int32)
    scal[0], scal[1], scal[2], scal[3] = qmax, qmax + 32, 100, h0
    return q, t, scal, np.array([qmax + 32], np.int32)


def test_i16_edge_of_range_is_exact():
    """a = b = 127 in a 128-column window with h0 = 127: the score reaches
    2^14 - 1, the top of the range, and the 16-bit cells still agree with
    the 32-bit ones and with the Pallas kernel at jnp.int16."""
    batch = _edge_batch(128, 127)
    prm = _prm(a=127, b=127, o_del=60, e_del=9, o_ins=70, e_ins=11)
    extend_cuda.check_i16_range(prm, 128, 160)
    want = _plain_t(batch, prm)
    assert want[0].max() == (1 << 14) - 1
    _all_equal(_plain_t(batch, prm, torch.int16), want,
               _pallas_t(batch, prm, jnp.int16))


# one query window per row of the 16-bit cells' launch table (and the
# shared-memory row above it), with the row's strip of C columns: the
# windows and band edges that the 16-bit kernels' tests (test_torch_simt16,
# chip_smoke.py) hold to this plain version, here held to the JAX package
_TABLE16 = gate.launch_table16(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bwamem_tpu_torch", "csrc", "launch_table.cuh"))
_WINDOWS16 = sorted({(q, c) for q, _, c in _TABLE16}
                    | {(_TABLE16[-1][0] + 1,
                        2 * -(-(_TABLE16[-1][0] + 1) // 64))})


@pytest.mark.parametrize("qmax,C", _WINDOWS16,
                         ids=[f"q{q}-C{c}" for q, c in _WINDOWS16])
def test_i16_band_edges_match_pallas_i16_and_i32(qmax, C):
    """The band-edge batches (tests/_torch_gate.edge_t_batch,
    edge_fused_batch: edges on every pair boundary and the half-strip seam
    of a C-column strip, odd query lengths, bands narrower than a strip):
    plain 16-bit == the Pallas kernels at jnp.int16 (interpret mode) ==
    the 32-bit plain version, every row and lane."""
    for zdrop in (100, 0):
        batch = gate.edge_t_batch(qmax + zdrop, qmax, C, BLK)
        prm = _prm(zdrop=zdrop)
        _all_equal(_plain_t(batch, prm, torch.int16),
                   _pallas_t(batch, prm, jnp.int16), _plain_t(batch, prm))
    batch = gate.edge_fused_batch(qmax, qmax, C, BLK)
    prm = _prm(zdrop=0)
    _all_equal(_plain(batch, prm, torch.int16),
               _pallas(batch, prm, jnp.int16), _plain(batch, prm))


@pytest.mark.parametrize("qmax", sorted({q for q, _ in _WINDOWS16}))
def test_i16_top_of_range_matches_pallas_i16_and_i32(qmax):
    """Scores at 2^14 - 1 in every window of the 16-bit table
    (tests/_torch_gate.top_of_range_t_batch): plain 16-bit == the Pallas
    kernel at jnp.int16 == the 32-bit plain version."""
    batch, prm = gate.top_of_range_t_batch(qmax, qmax, BLK)
    extend_cuda.check_i16_range(prm, qmax, batch[1].shape[0])
    want = _plain_t(batch, prm)
    assert want[0].max() == (1 << 14) - 1
    _all_equal(_plain_t(batch, prm, torch.int16), want,
               _pallas_t(batch, prm, jnp.int16))


@pytest.mark.parametrize("qlen", sorted(gate.TRIM_PAST_ROW))
def test_i16_trim_past_the_row_matches_pallas_and_oracle(qlen):
    """The lanes whose trim reads column endc past the 16-bit pass's last
    strip (tests/_torch_gate.TRIM_PAST_ROW): plain 16-bit == the Pallas
    kernel at jnp.int16 == the 32-bit plain version, and fields 0-5 ==
    ksw_extend_core."""
    batch, prm = gate.trim_past_row_t_batch(qlen, BLK)
    got = _plain_t(batch, prm, torch.int16)
    _all_equal(got, _pallas_t(batch, prm, jnp.int16), _plain_t(batch, prm))
    n, bad = _oracle_mismatches(got, batch[0], batch[1], batch[2], prm)
    assert n == BLK and bad == [], bad[:3]


@pytest.mark.parametrize("prm,qmax,tmax,why", [
    (_prm(a=127, b=127), 160, 192, "a\\*qmax"),
    (_prm(e_ins=17), 1024, 64, "e_ins"),
    (_prm(o_ins=1 << 14), 64, 64, "open \\+ extend"),
    (_prm(e_del=100), 64, 192, "e_del"),
    (_prm(e_del=61, e_ins=61), 160, 192, "max\\(e_del, e_ins\\)"),
    (_prm(zdrop=1 << 15), 64, 64, "zdrop"),
    (_prm(), 64, 8200, "target window"),
    (_prm(o_del=-1), 64, 64, "negative"),
])
def test_i16_wrapper_refuses_outside_the_range(prm, qmax, tmax, why):
    """Just outside the stated range the wrappers raise (from host data:
    shapes and penalties), and the 32-bit path takes the same call."""
    with pytest.raises(ValueError, match=why):
        extend_cuda.check_i16_range(prm, qmax, tmax)
    q = torch.zeros((qmax, BLK), dtype=torch.int8)
    t = torch.zeros((tmax, BLK), dtype=torch.int8)
    scal = torch.zeros((8, BLK), dtype=torch.int32)
    with pytest.raises(ValueError, match="16-bit"):
        extend_cuda.extend_batch_raw_t(q, t, scal, None, prm,
                                       compute_dtype=torch.int16)
    scal16 = torch.zeros((16, BLK), dtype=torch.int32)
    with pytest.raises(ValueError, match="16-bit"):
        extend_cuda.extend_batch_raw_fused(q, t, q, t, scal16, None, prm,
                                           compute_dtype=torch.int16)
    if prm[2] >= 0 and tmax < 1000:
        extend_cuda.extend_batch_raw_t(q, t, scal, None, prm)


def test_compute_dtype_must_be_int32_or_int16():
    q = torch.zeros((16, BLK), dtype=torch.int8)
    scal = torch.zeros((8, BLK), dtype=torch.int32)
    with pytest.raises(ValueError, match="compute_dtype"):
        extend_cuda.extend_batch_raw_t(q, q, scal, None, _prm(),
                                       compute_dtype=torch.int64)


def test_i16_host_half_matches_i32():
    """ops/extend.make_raw_backend hands compute_dtype down: the Python
    host's backend with 16-bit cells gives the 32-bit ExtendOut."""
    q, qlen, t, tlen, w, h0, _, _ = _tasks(6, 2 * BLK, 40, 80)
    p = types.params_from_jax(ExtendParams(
        mat_flat=jnp.asarray(build_mat(1, 4).astype(np.int32).ravel()),
        m=5, o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100))
    outs = [extend.make_raw_backend(p, torch.device("cpu"), blk_l=BLK,
                                    compute_dtype=dt)(q, qlen, t, tlen, w, h0)
            for dt in (torch.int32, torch.int16)]
    for f in types.ExtendOut._fields:
        assert np.array_equal(getattr(outs[0], f), getattr(outs[1], f)), f


def _lane_outside(factory, field):
    """A backend of `factory` with 16-bit cells and a call whose lane 3
    is outside the per-lane range in `field` (h0 too high for a*qmax, or
    a band of 2^14); the rest of the batch is inside it."""
    from bwamem_tpu_torch.pipeline import native_driver

    p = types.params_from_jax(ExtendParams(
        mat_flat=jnp.asarray(build_mat(1, 4).astype(np.int32).ravel()),
        m=5, o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100))
    kw = dict(blk_l=BLK, compute_dtype=torch.int16)
    cpu = torch.device("cpu")
    bad = (1 << 14) - 40 if field == "h0" else 1 << 14
    if factory == "raw":
        q, qlen, t, tlen, w, h0, _, _ = _tasks(6, BLK, 40, 80)
        args = [q, qlen, t, tlen, np.array(w), np.array(h0)]
        args[5 if field == "h0" else 4][3] = bad
        return extend.make_raw_backend(p, cpu, **kw), args
    if factory == "raw_t":
        q, t, scal, tmax = gate.random_t_batch(8, BLK, 40, 80, blk_l=BLK)
        scal[3 if field == "h0" else 2, 3] = bad
        return native_driver.make_raw_t_backend(p, cpu, **kw), [q, t, scal,
                                                                tmax]
    batch = list(gate.random_fused_batch(8, BLK, (24, 48, 24, 48),
                                         blk_l=BLK))
    # the fused bound counts both windows: 2^14 - 40 is inside for either
    # window alone (a*24) and outside for the two together (a*48)
    batch[4][3 if field == "h0" else 8, 3] = bad
    return native_driver.make_fused_backend(p, cpu, **kw), batch


@pytest.mark.parametrize("field", ["h0", "band"])
@pytest.mark.parametrize("factory", ["raw", "raw_t", "fused"])
def test_i16_backends_refuse_a_lane_outside_the_range(factory, field):
    """The three backend factories that hold the scalar block on the host
    check the data half of the 16-bit range there (h0 + a*qmax < 2^14,
    0 <= band < 2^14) and raise instead of returning a saturated score;
    the same call passes once the lane is back inside."""
    fn, args = _lane_outside(factory, field)
    with pytest.raises(ValueError, match="16-bit"):
        fn(*args)
    fn2, good = _lane_outside(factory, field)
    for x in good:
        x[x >= (1 << 14) - 40] = 7
    fn2(*good)
