"""BENCHMARK.json holds to the benchmark's contract: keys, names, units,
bounds, where files lie, what each cell reports, and what a full check
costs."""

import json
import os
import re

import pytest

from perfbench.registry import REPO, ROOT, Registry

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert os.path.isdir(os.path.join(REPO, p))


def test_run_seconds_fit_a_full_check_of_24_cells():
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    runs = 2 + 14 * 24
    assert runs * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        assert os.path.isfile(os.path.join(ROOT, "traffic",
                                           w["traffic"] + ".json"))


def test_metrics():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in e2e)
    layers = {}
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in {x["name"] for x in e2e}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert os.path.isfile(os.path.join(ROOT, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_enough(cell):
    reg = Registry()
    e2e = {m["name"] for m in reg.metrics_for(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reg.metrics_for(cell, True)
