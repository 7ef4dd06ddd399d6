"""The port's plain extensions (bwamem_tpu_torch/ops/extend_torch.py:
the fused four-pass and the per-phase one-pass) against the JAX
package's Pallas kernels in interpret mode
(extend_pallas.extend_batch_raw_fused, extend_batch_raw_t) and the
scalar bwa-0.7.8 oracle (extend_ref.ksw_extend_core), and the port's
host half (ops/extend.py) against extend_pallas's.  Inputs are made
from a seed with numpy; tolerance is exact — every output is an
integer — on every row and lane, padding lanes and lanes that did not
retry included."""

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


def _pallas(batch, prm):
    ql, tl, qr, tr, scal, tmax2 = batch
    return np.asarray(extend_pallas.extend_batch_raw_fused(
        *(jnp.asarray(x.astype(np.int32)) for x in (ql, tl, qr, tr)),
        jnp.asarray(scal), jnp.asarray(tmax2), jnp.asarray(prm),
        blk_l=BLK, interpret=True))


def _plain(batch, prm):
    out = extend_cuda.extend_batch_raw_fused(
        *(torch.from_numpy(x) for x in batch), prm)
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


def _pallas_t(batch, prm):
    q, t, scal, tmax = batch
    return np.asarray(extend_pallas.extend_batch_raw_t(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(t.astype(np.int32)),
        jnp.asarray(scal), jnp.asarray(tmax), prm=jnp.asarray(prm),
        blk_l=BLK, interpret=True))


def _plain_t(batch, prm):
    out = extend_cuda.extend_batch_raw_t(
        *(torch.from_numpy(x) for x in batch), prm)
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
                              blk_b=BLK)
    assert isinstance(got, types.ExtendOut)
    for f in types.ExtendOut._fields:
        g = getattr(got, f)
        assert isinstance(g, np.ndarray), f
        assert np.array_equal(g, np.asarray(getattr(want, f))), f
    for a, b in zip(extend.pack_scal(qlen, tlen, w, h0, blk_b=BLK),
                    extend_pallas.pack_scal(qlen, tlen, w, h0, blk_b=BLK)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


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
