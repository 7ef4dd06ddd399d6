"""The rate, layer and idle arithmetic on made-up spans."""

import importlib.util
import json
import os

import pytest

from harness import cell, feed, trace

from _tiny import ROOT


def test_done_curve_and_rate():
    sink = feed.SamSink()
    sink.writes = [(0.0, "@HD\tVN:1.5\n"),
                   (1.0, "r0000000000\t0\n" * 1 + "r0000000063\t4\n"),
                   (2.5, "r0000000127\t0\n"),
                   (4.0, "r0000000191\t0\n")]
    curve = sink.done_curve()
    assert curve == [(1.0, 64), (2.5, 128), (4.0, 192)]
    assert cell.done_at(curve, 0.5) == 0
    assert cell.done_at(curve, 2.5) == 128
    assert cell.done_at(curve, 3.9) == 128


def test_last_index_of_pairs_and_headers():
    assert feed.last_index("@SQ\tSN:x\n") == -1
    assert feed.last_index("p0000000041\t99\np0000000041\t147\n") == 41


def test_union_and_idle_gaps():
    iv = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0)]
    assert trace.union_seconds(iv) == pytest.approx(2.5)
    assert trace.idle_gaps(iv, 0.0, 5.0) == [(1.5, 3.0), (4.0, 5.0)]


def test_gaps_named_by_open_host_rows():
    rows = [{"kind": "host_chunk", "reads": 2048, "t": 3.0, "sec": 1.6},
            {"kind": "host_chunk", "reads": 0, "t": 5.0, "sec": 0.5}]
    iv = [("k", 0.0, 1.0), ("k", 3.0, 4.0)]
    bd = trace.breakdown(iv, rows, 0.0, 5.0)
    assert bd["device_ops"] == [["k", 2.0]]
    assert bd["idle_gaps"] == [["host_start", 2.0], ["host_finish", 1.0]]


def _reader(name):
    path = os.path.join(ROOT, "gpubench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(**kw):
    base = dict(rows=[], reads=4096, window_s=2.0, intervals=None,
                busy_s=0.0)
    base.update(kw)
    return cell.Context(**base)


def test_layer_readers_on_made_up_rows():
    rows = [{"kind": "host_chunk", "reads": 2048, "t": 1, "sec": 0.1},
            {"kind": "host_chunk", "reads": 2048, "t": 2, "sec": 0.3},
            {"kind": "host_chunk", "reads": 0, "t": 2, "sec": 0.2},
            {"kind": "extend_fused", "cells": 10 ** 9, "t": 2,
             "sec": 0.05},
            {"kind": "rescue_w0", "cells": 5, "t": 2, "sec": 0.004},
            {"kind": "cigar_r1", "cells": 5, "t": 2, "sec": 0.008}]
    c = _ctx(rows=rows)
    assert _reader("host_start_ms_per_kread")(c) == pytest.approx(
        400.0 / 4.096)
    # the rescue and CIGAR rows open inside the finish span: self time
    assert _reader("host_finish_ms_per_kread")(c) == pytest.approx(
        (200.0 - 4 - 8) / 4.096)
    assert _reader("extend_call_ms_per_kread")(c) == pytest.approx(
        50.0 / 4.096)
    assert _reader("rescue_ms_per_kread")(c) == pytest.approx(4 / 4.096)
    # nothing to read: no value, never 0
    assert _reader("rescue_ms_per_kread")(_ctx()) is None
    assert _reader("device_idle_pct")(_ctx()) is None
    assert _reader("extend_fused.kernel_ms_per_kread")(c) is None


def test_device_readers():
    rows = [{"kind": "extend_fused", "cells": 10 ** 9, "t": 1, "sec": 0.1}]
    iv = [("void extend_fused_kernel<4>(...)", 0.0, 0.02),
          ("Memcpy HtoD", 0.5, 0.52)]
    c = _ctx(rows=rows, intervals=iv, busy_s=trace.union_seconds(iv))
    assert _reader("device_idle_pct")(c) == pytest.approx(98.0)
    # only the kernel's own intervals: the copy is not the kernel's time
    assert _reader("extend_fused.kernel_ms_per_kread")(c) == pytest.approx(
        20.0 / 4.096)
    # a trace without the kernel: no value, never 0
    c = _ctx(intervals=iv[1:], busy_s=0.02)
    assert _reader("extend_fused.kernel_ms_per_kread")(c) is None


def test_chrome_trace_on_the_host_clock(tmp_path):
    events = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": 1000.0,
         "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1500.0,
         "dur": 250},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 900.0, "dur": 200},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1500.0,
         "dur": 5}]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(events))
    iv = trace.device_intervals(str(p), 100.0, 1.0)
    assert [n for n, _, _ in iv] == ["k", "Memcpy DtoH"]
    k = iv[0]
    assert k[1] == pytest.approx(100.0005) and k[2] == pytest.approx(
        100.00075)
    assert iv[1][1] == pytest.approx(100.0)      # clipped to the window
