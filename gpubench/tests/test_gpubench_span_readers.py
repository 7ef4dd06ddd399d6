"""The readers of the port's in-program spans on made-up rows: each picks
its own kinds, gives None where none is present (never 0), and none of
them picks a row that the older readers' selections already count."""

import importlib.util
import os

import pytest

from harness import cell, trace

from _tiny import ROOT

NEW = {"input_wait_ms_per_kread": ["input.read"],
       "input_parse_ms_per_kread": ["input.parse"],
       "seed_ms_per_kread": ["seed"],
       "pair_ms_per_kread": ["pair"],
       "h2d_ms_per_kread": ["fused.h2d", "rescue.h2d", "cigar.h2d"],
       "launch_ms_per_kread": ["fused.launch", "rescue.launch",
                               "cigar.launch"],
       "wait_ms_per_kread": ["fused.wait", "rescue.wait", "cigar.wait"]}
# the spans no metric of their own reads: the breakdown's gap names
UNREAD = ["chunk.prep", "sam.write", "fused.fill", "fused.done",
          "rescue.build", "rescue.fill", "rescue.apply", "cigar.fill",
          "chunk.pack", "chain_plan", "replay", "pestat", "sam.emit", "gc",
          "chunk.join", "trace.flush"]
OLD = ["host_start_ms_per_kread", "host_finish_ms_per_kread",
       "extend_call_ms_per_kread", "rescue_ms_per_kread"]


def _reader(name):
    path = os.path.join(ROOT, "gpubench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "s_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(rows):
    return cell.Context(rows=rows, reads=4096, window_s=2.0,
                        intervals=None, busy_s=0.0)


def _old_rows():
    return [{"kind": "host_chunk", "reads": 4096, "t": 1.0, "sec": 0.3},
            {"kind": "host_chunk", "reads": 0, "t": 2.0, "sec": 0.2},
            {"kind": "extend_fused", "cells": 9, "t": 1.2, "sec": 0.05},
            {"kind": "rescue_w0", "cells": 5, "t": 1.9, "sec": 0.004},
            {"kind": "cigar_r0", "cells": 5, "t": 1.95, "sec": 0.008}]


def _new_rows():
    """One row of each new kind, each of its own length (ms: 1, 2, ...),
    all inside the rows of _old_rows."""
    kinds = [k for ks in NEW.values() for k in ks] + UNREAD
    return [{"kind": k, "t": 1.5, "sec": (i + 1) * 1e-3, "id": 100 + i,
             "parent": None, "chunk": 0} for i, k in enumerate(kinds)]


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_reader_picks_its_own_spans(name):
    rows = _old_rows() + _new_rows()
    want = sum(r["sec"] for r in rows if r["kind"] in NEW[name])
    assert _reader(name)(_ctx(rows)) == pytest.approx(
        1e3 * want / 4.096)


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_reader_gives_none_without_its_spans(name):
    rows = _old_rows() + [r for r in _new_rows()
                          if r["kind"] not in NEW[name]]
    assert _reader(name)(_ctx(rows)) is None
    assert _reader(name)(_ctx([])) is None


def test_old_readers_count_no_new_span():
    """host_finish's self time and rescue's waves read the same with the
    new spans in the trace as without them: no row is counted twice."""
    old = _ctx(_old_rows())
    both = _ctx(_old_rows() + _new_rows())
    for name in OLD:
        assert _reader(name)(both) == pytest.approx(_reader(name)(old))
    assert _reader("rescue_ms_per_kread")(both) == pytest.approx(
        4 / 4.096)
    assert _reader("host_finish_ms_per_kread")(both) == pytest.approx(
        (200 - 4 - 8) / 4.096)


def test_new_spans_name_the_gaps_they_cover():
    rows = [{"kind": "input.read", "t": 3.0, "sec": 1.0},
            {"kind": "host_chunk", "reads": 0, "t": 5.0, "sec": 1.5},
            {"kind": "rescue.wait", "t": 4.5, "sec": 0.6}]
    iv = [("k", 0.0, 2.0), ("k", 3.0, 3.5)]
    gaps = trace.breakdown(iv, rows, 0.0, 5.0)["idle_gaps"]
    assert gaps == [["host_finish+rescue.wait", 1.5],
                    ["input.read", 1.0]]

