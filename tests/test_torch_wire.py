"""The port's wire-format codec (bwamem_tpu_torch/pipeline/wire.py)
against the JAX package's copy: tests/test_wire.py's round trips and
layout checks on the port's module, and every packed image equal, word
for word, to the reference's for the same tasks, each decoded by the
other package too."""

import dataclasses

import numpy as np
import pytest
import torch

from bwamem_tpu.pipeline import wire as ref_wire
from bwamem_tpu_torch.pipeline import wire

from _torch_gate import plain

torch.set_num_threads(1)


def _rand_task(rng, tid):
    return wire.WireTask(
        q_left=rng.integers(0, 5, rng.integers(0, 120)).astype(np.int8),
        q_right=rng.integers(0, 5, rng.integers(0, 120)).astype(np.int8),
        t_left=rng.integers(0, 5, rng.integers(0, 300)).astype(np.int8),
        t_right=rng.integers(0, 5, rng.integers(0, 300)).astype(np.int8),
        qbeg_ori=int(rng.integers(0, 1 << 15)),
        regscore=int(rng.integers(0, 1 << 15)),
        h0=int(rng.integers(1, 256)),
        max_ins=int(rng.integers(1, 1 << 16)),
        max_del=int(rng.integers(1, 1 << 16)),
        task_id=tid,
    )


def _ref(x):
    """A WireHeader / WireTask / WireResult of the port as the
    reference's class, the same field values."""
    return getattr(ref_wire, type(x).__name__)(
        **{f.name: getattr(x, f.name) for f in dataclasses.fields(x)})


def _pack(hdr, tasks):
    """The port's image of a batch, held word for word to the
    reference's."""
    img = wire.pack_batch(hdr, tasks)
    want = ref_wire.pack_batch(_ref(hdr), [_ref(t) for t in tasks])
    assert img.dtype == want.dtype and img.shape == want.shape
    np.testing.assert_array_equal(img, want)
    return img


def _unpack(img):
    got = wire.unpack_batch(img)
    assert plain(got) == plain(ref_wire.unpack_batch(img))
    return got


def test_batch_roundtrip():
    rng = np.random.default_rng(0)
    hdr = wire.WireHeader(o_del=6, e_del=1, o_ins=6, e_ins=1,
                          pen_clip_left=5, pen_clip_right=5, w=100)
    tasks = [_rand_task(rng, i) for i in range(40)]
    img = _pack(hdr, tasks)
    assert img.shape == (wire.TBB_WORDS,) and img.dtype == np.uint32
    assert wire.TBB_WORDS == ref_wire.TBB_WORDS
    hdr2, tasks2 = _unpack(img)
    assert hdr2 == hdr
    assert len(tasks2) == len(tasks)
    for a, b in zip(tasks, tasks2):
        np.testing.assert_array_equal(a.q_left, b.q_left)
        np.testing.assert_array_equal(a.q_right, b.q_right)
        np.testing.assert_array_equal(a.t_left, b.t_left)
        np.testing.assert_array_equal(a.t_right, b.t_right)
        assert (a.qbeg_ori, a.regscore, a.h0, a.task_id) == (
            b.qbeg_ori, b.regscore, b.h0, b.task_id)
        assert (a.max_ins, a.max_del) == (b.max_ins, b.max_del)


def test_payload_word_layout_msb_first():
    """First base lands in bits [31:28] (proc_element.v:1677, 1638)."""
    hdr = wire.WireHeader(6, 1, 6, 1, 5, 5, 100)
    t = wire.WireTask(
        q_left=np.array([1, 2, 3], np.int8), q_right=np.array([], np.int8),
        t_left=np.array([4], np.int8), t_right=np.array([], np.int8),
        qbeg_ori=0, regscore=0, h0=1, max_ins=1, max_del=1, task_id=7)
    img = _pack(hdr, [t])
    payload_word = img[8 + 8 * 1]  # one task -> payload starts at word 16
    assert payload_word == (1 << 28) | (2 << 24) | (3 << 20) | (4 << 16)


def test_rebase_with_host_offsets():
    """Host-buffer-relative taskDataPos (word 10 bias) decodes correctly:
    shift every d2 by a constant, as the real host software would."""
    rng = np.random.default_rng(1)
    hdr = wire.WireHeader(6, 1, 6, 1, 5, 5, 100)
    tasks = [_rand_task(rng, i) for i in range(5)]
    img = _pack(hdr, tasks).copy()
    for i in range(5):
        img[8 + 8 * i + 2] += 12345  # simulate host-software offsets
    _, tasks2 = _unpack(img)
    for a, b in zip(tasks, tasks2):
        np.testing.assert_array_equal(a.q_left, b.q_left)
        np.testing.assert_array_equal(a.t_right, b.t_right)


def test_results_roundtrip_and_sentinel():
    rng = np.random.default_rng(2)
    res = [
        wire.WireResult(
            task_id=int(rng.integers(0, 1 << 31)),
            qbeg=int(rng.integers(-100, 100)), qend=int(rng.integers(0, 200)),
            rbeg=int(rng.integers(-2000, 0)), rend=int(rng.integers(0, 2000)),
            score=int(rng.integers(0, 500)),
            true_score=int(rng.integers(0, 500)),
            w_used=int(rng.integers(1, 400)))
        for _ in range(30)
    ]
    img = wire.pack_results(res)
    np.testing.assert_array_equal(
        img, ref_wire.pack_results([_ref(r) for r in res]))
    assert img[30 * 5] == wire.SENTINEL == ref_wire.SENTINEL
    back = wire.unpack_results(img)
    assert back == res
    assert plain(back) == plain(ref_wire.unpack_results(img))


@pytest.mark.parametrize("n", [819, 820])
def test_capacity_limit_819(n):
    """819 tasks fit a batch in both packages; 820 are refused by both."""
    hdr = wire.WireHeader(6, 1, 6, 1, 5, 5, 100)
    t = wire.WireTask(np.array([0], np.int8), np.array([], np.int8),
                      np.array([0], np.int8), np.array([], np.int8),
                      0, 0, 1, 1, 1, 0)
    if n <= 819:
        assert len(_unpack(_pack(hdr, [t] * n))[1]) == n
        return
    with pytest.raises(AssertionError):
        wire.pack_batch(hdr, [t] * n)
    with pytest.raises(AssertionError):
        ref_wire.pack_batch(_ref(hdr), [_ref(t)] * n)
