"""The port's `mem --trace` spans (utils/metrics.py) on the tiny PE and
SE world of tests/test_torch_cli.py, `--backend torch`: every kind
appears, each child row lies inside its parent and names a row of the
trace, the C++ phase stamps fall inside the `host_chunk` row of the call
that made them, a run without `--trace` registers no collection
callback and writes no file, a run that fails still writes its rows
and takes its callback away, and device rescue makes one batch a chunk
whose computed and applied tasks the counters sum."""

import collections
import contextlib
import gc
import io
import json
import os

import pytest
import torch

from bwamem_tpu_torch.__main__ import main
from bwamem_tpu_torch.pipeline import native_driver
from bwamem_tpu_torch.utils import metrics

from test_torch_cli import hard_files  # noqa: F401 (a fixture)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not native_driver.available(),
                                reason="native library unavailable")

SLACK = 1e-3           # seconds a child may pass its parent's ends by
CALL_ROW = {"fused": "extend_fused", "rescue": "rescue_w",
            "cigar": "cigar_r"}   # the row a device call's spans sit in

TOP = {"input.read", "input.parse", "chunk.prep", "fused.fill",
       "fused.done", "sam.write", "gc"}
HOST = {"chunk.pack", "seed", "chain_plan", "sam.emit"}
CALL = {f"{c}.{p}" for c in ("fused", "rescue", "cigar")
        for p in ("h2d", "launch", "wait")}
CASES = {
    # device rescue and CIGARs: mp_pe_prepare, waves, mp_finalize_pe_tail
    "pe_device": (["--device-rescue", "--device-cigar"], True,
                  TOP | HOST | CALL | {"replay", "pestat", "pair",
                                       "rescue.build", "rescue.fill",
                                       "rescue.apply", "rescue.replay",
                                       "cigar.fill"}),
    # host rescue: mp_finalize_pe
    "pe_host": ([], True, TOP | HOST | {"replay", "pestat", "pair"}
                | {c for c in CALL if c.startswith("fused")}),
    # SE, two chunks in flight: the main thread waits on a worker
    "se": (["--inflight", "2", "--device-cigar"], False,
           TOP | HOST | CALL - {c for c in CALL if c.startswith("rescue")}
           | {"chunk.join", "cigar.fill"}),
}


class _Out(io.StringIO):
    """Standard output that forces a full collection at every write and
    counts the collection callbacks registered then."""

    def __init__(self):
        super().__init__()
        self.callbacks = []

    def write(self, s):
        self.callbacks.append(len(gc.callbacks))
        gc.collect()
        return super().write(s)


def _mem(files, flags, mates, trace=None):
    """The port's mem on the world, 16 reads (pairs) a chunk: (stdout,
    the collection callbacks before the run); stdout's `err` holds the
    standard error."""
    args, mate_file, *_ = files
    out, before, err = _Out(), len(gc.callbacks), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["mem", "--backend", "torch", "-b", "16", *flags,
                   *(["--trace", trace] if trace else []), *args,
                   *(mate_file if mates else [])])
    assert rc == 0
    out.err = err.getvalue()
    return out, before


@pytest.fixture(scope="module")
def runs(hard_files):  # noqa: F811
    """{case: (rows of its trace, its `[mem] counters` line)}, each case
    run once."""
    *files, tmp = hard_files
    got = {}
    for case, (flags, mates, _) in CASES.items():
        path = os.path.join(tmp, f"spans_{case}.jsonl")
        out, before = _mem(files, flags, mates, trace=path)
        assert set(out.callbacks) == {before + 1}     # the tracer's own
        assert len(gc.callbacks) == before            # gone at close
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        line = out.err.split("[mem] counters: ")[1].splitlines()[0]
        got[case] = rows, json.loads(line)
    return got


@pytest.fixture(scope="module")
def traces(runs):
    """{case: rows of its trace}."""
    return {case: rows for case, (rows, _) in runs.items()}


def _kinds(rows):
    return collections.Counter(r["kind"] for r in rows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_span_kind_appears(traces, case):
    kinds = _kinds(traces[case])
    want = CASES[case][2]
    assert want <= set(kinds), sorted(want - set(kinds))
    # the rows the benchmark already reads keep their kinds and fields
    starts = [r for r in traces[case] if r["kind"] == "host_chunk"
              and r["reads"] > 0]
    assert len(starts) == kinds["host_chunk"] // 2 > 1
    calls = [r for r in traces[case]
             if r["kind"].startswith(("extend_fused", "rescue_w",
                                      "cigar_r"))]
    assert calls
    for r in calls:
        assert {"n_tasks", "cells", "Bp", "qmax", "tmax", "h2d_bytes",
                "copies"} <= set(r), r
        assert r["h2d_bytes"] > 0 and r["copies"] >= 2
    # the chunk numbers of the loop, from 0
    assert sorted(r["chunk"] for r in starts) == list(range(len(starts)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_children_lie_inside_their_parents(traces, case):
    rows = traces[case]
    by_id = {r["id"]: r for r in rows}
    assert len(by_id) == len(rows)
    for r in rows:
        if r["parent"] is None:
            continue
        p = by_id[r["parent"]]
        assert p["t"] - p["sec"] - SLACK <= r["t"] - r["sec"], (r, p)
        assert r["t"] <= p["t"] + SLACK, (r, p)
        call, _, part = r["kind"].partition(".")
        if part in ("h2d", "launch", "wait"):
            assert p["kind"].startswith(CALL_ROW[call]), (r, p)


@pytest.mark.parametrize("case", sorted(CASES))
def test_seeding_stamps_fall_inside_the_chunk_start(traces, case):
    rows = traces[case]
    by_id = {r["id"]: r for r in rows}
    stamped = [r for r in rows if r["kind"] in ("seed", "chain_plan")]
    assert len(stamped) == 2 * sum(1 for r in rows if r["kind"] ==
                                   "host_chunk" and r["reads"] > 0)
    for r in stamped:
        p = by_id[r["parent"]]
        assert p["kind"] == "host_chunk" and p["reads"] > 0
        assert p["t"] - p["sec"] <= r["t"] - r["sec"] <= r["t"] <= p["t"]
    # and the finish's phases inside the finish
    for r in rows:
        if r["kind"] in ("replay", "pestat", "pair"):
            p = by_id[r["parent"]]
            assert p["kind"] == "host_chunk" and p["reads"] == 0


def test_untraced_run_registers_nothing_and_writes_nothing(hard_files,
                                                           traces):
    *files, tmp = hard_files
    flags, mates, _ = CASES["pe_device"]
    listed = sorted(os.listdir(tmp))
    out, before = _mem(files, flags, mates)
    assert set(out.callbacks) == {before}
    assert sorted(os.listdir(tmp)) == listed
    # the same SAM records as a traced run's
    traced, _ = _mem(files, flags, mates,
                     trace=os.path.join(tmp, "again.jsonl"))
    body = [[l for l in o.getvalue().splitlines() if not l.startswith("@")]
            for o in (out, traced)]
    assert body[0] == body[1] and body[0]


def test_failed_run_writes_its_rows(hard_files, traces):
    """A mate file four records short: the loop aligns three chunks of
    16 pairs, then raises on the fourth; the trace holds the rows up to
    the fault and the collection callback is gone."""
    (fa, r1), (r2,), _, tmp = hard_files
    with open(r2) as f:
        lines = f.read().splitlines(keepends=True)
    short = os.path.join(tmp, "r2_short.fq")
    with open(short, "w") as f:
        f.writelines(lines[:4 * 60])
    path = os.path.join(tmp, "spans_failed.jsonl")
    before = list(gc.callbacks)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(ValueError, match="read/mate count mismatch"):
        main(["mem", "--backend", "torch", "-b", "16", "--trace", path,
              fa, r1, short])
    assert gc.callbacks == before
    with open(path) as f:
        kinds = _kinds(map(json.loads, f))
    assert kinds["host_chunk"] == 6            # three chunks, start+finish
    assert kinds["input.read"] and kinds["input.parse"]


def test_rows_written_in_blocks(tmp_path, monkeypatch):
    """Rows stay in memory until a block is full and no span is open in
    the thread; the write is a row of its own; close() writes the rest."""
    monkeypatch.setattr(metrics, "FLUSH_ROWS", 4)
    path = tmp_path / "t.jsonl"

    def written():     # less the collections that happen to be timed
        return [r for r in map(json.loads, path.read_text().splitlines())
                if r["kind"] != "gc"]

    tr = metrics.Tracer(str(path))
    with metrics.span(tr, "outer") as outer:
        for _ in range(6):
            with metrics.span(tr, "inner"):
                pass
        assert written() == []                 # a span is open
        outer.fields["n"] = 6
    rows = written()
    assert [r["kind"] for r in rows] == ["inner"] * 6 + ["outer"]
    assert all(r["parent"] == rows[-1]["id"] for r in rows[:6])
    assert rows[-1]["n"] == 6 and rows[-1]["parent"] is None
    tr.stamp("seed", rows[0]["t"] - 1e-4, rows[0]["t"])
    tr.close()
    rest = written()[7:]
    assert [r["kind"] for r in rest] == ["trace.flush", "seed"]
    assert rest[0]["rows"] == 7
    assert metrics.span(None, "x") is metrics.span(None, "y")


def test_rescue_batches_and_their_use(runs):
    """Device rescue makes one batch a chunk here (the superset is far
    below the lane cap): `rescue.build` and `rescue.replay` once a
    chunk, at most one `rescue_w<k>` row, each with `n_tasks` computed
    and `n_used` applied, whose sums are the counters' `rescue_tasks`
    and `rescue_used`; a run without device rescue counts none."""
    rows, ctr = runs["pe_device"]
    kinds = _kinds(rows)
    chunks = kinds["host_chunk"] // 2
    assert kinds["rescue.build"] == kinds["rescue.replay"] == chunks > 1
    batches = [r for r in rows if r["kind"].startswith("rescue_w")]
    assert batches and {r["kind"] for r in batches} == {"rescue_w0"}
    assert len({r["chunk"] for r in batches}) == len(batches) <= chunks
    for r in batches:
        assert 0 <= r["n_used"] <= r["n_tasks"] <= r["Bp"], r
    assert ctr["rescue_tasks"] == sum(r["n_tasks"] for r in batches) > 0
    assert ctr["rescue_used"] == sum(r["n_used"] for r in batches) > 0
    for case in ("pe_host", "se"):
        assert runs[case][1]["rescue_tasks"] == 0
        assert runs[case][1]["rescue_used"] == 0
        assert not _kinds(runs[case][0])["rescue.build"]
