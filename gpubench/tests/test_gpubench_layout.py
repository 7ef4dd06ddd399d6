"""Cells, configurations, traffic mixes and metric readers are found by
the names BENCHMARK.json gives them, and the names keep to the rules."""

import json
import os
import re

from _tiny import ROOT

BENCH = os.path.join(ROOT, "gpubench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_finds_its_files():
    b = _bench()
    cfgs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in cfgs
        with open(os.path.join(BENCH, "configs", w["config"] + ".json")) \
                as f:
            cfg = json.load(f)
        assert cfg["name"] == w["config"]
        assert cfg["reduced"] == cfgs[w["config"]]["reduced"]
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) \
                as f:
            assert json.load(f)["name"] == w["traffic"]
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_every_metric_has_a_reader_and_keeps_the_rules():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"reads_per_s", "cpu_s_per_mread", "setup_s"}
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
