"""The harness finds configurations, mixes, metric readers, roofline counts
and references by name, and a new one is a new file."""

import json
import os
import shutil

import pytest

from perfbench.registry import REPO, ROOT, Registry
from perfbench.tests.tiny import cells


def test_every_cell_resolves():
    reg = Registry()
    for name in cells():
        cell = reg.workload(name)
        cfg = reg.config(cell["config"])
        assert cfg["name"] == cell["config"]
        mix = reg.traffic(cell["traffic"])
        entry = "exact_topk_live" if mix.get("writers") else "exact_topk"
        assert callable(getattr(reg.reference(cfg["reference"]), entry))
        for trace in (False, True):
            for m in reg.metrics_for(name, trace):
                assert callable(reg.metric(m["name"]).read)


@pytest.mark.parametrize("kernel", ["scan", "ivf_probe"])
def test_roofline_counts_resolve(kernel):
    mod = Registry().roofline(kernel)
    assert mod.MAIN in mod.KERNELS and callable(mod.launches)


def test_metrics_for_follows_workloads_and_moves():
    reg = Registry()
    per = {m["name"] for m in reg.metrics_for("flat-f32-1m.b1", True)}
    assert "scan_roofline" in per and "ivf_probe_roofline" not in per
    e2e = {m["name"] for m in reg.metrics_for("ivf-f32-1m.b256", False)}
    assert {"setup_s", "search_qps"} <= e2e


def test_unknown_names_raise():
    reg = Registry()
    with pytest.raises(KeyError):
        reg.workload("no-such-cell")
    with pytest.raises(KeyError):
        reg.metric("no_such_metric")


def test_new_entries_are_files_only(tmp_path):
    """A throwaway configuration, mix, metric and roofline count, added as
    files (and entries) beside copies of the real ones, are found by name
    with no file of the harness changed."""
    root = tmp_path / "perfbench"
    for kind in ("configs", "traffic", "metrics", "roofline", "reference"):
        shutil.copytree(os.path.join(ROOT, kind), root / kind)
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for c in bench["configs"]:
        shutil.copy(os.path.join(REPO, c["file"]), tmp_path / c["file"])
    base = json.load(open(root / "configs" / "clip-b32-flat-f32-1m.json"))
    base["name"] = "throwaway-cfg"
    json.dump(base, open(root / "configs" / "throwaway-cfg.json", "w"))
    json.dump({"loop": "closed", "clients": 2, "batch": 4, "k": 3,
               "pool_queries": 64, "query_spread": 0.4, "warm_calls": 1,
               "check_queries": 8},
              open(root / "traffic" / "throwaway-mix.json", "w"))
    (root / "metrics" / "throwaway_metric.py").write_text(
        "def read(run):\n    return 7.0\n")
    (root / "roofline" / "throwaway_kernel.py").write_text(
        "KERNELS = ('k',)\nMAIN = 'k'\n"
        "def launches(run):\n    return [(1.0, 2.0)]\n")
    bench["configs"].append({"name": "throwaway-cfg", "source": "x",
                             "file": "perfbench/configs/throwaway-cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "throwaway.cell",
                               "config": "throwaway-cfg",
                               "traffic": "throwaway-mix", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "search_qps":  # an entry names the cell's metrics
            m["workloads"].append("throwaway.cell")
    bench["per_layer"].append({"name": "throwaway_metric", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "engine", "moves": "search_qps"})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    reg = Registry(root=str(root), repo=str(tmp_path))
    cell = reg.workload("throwaway.cell")
    assert reg.config(cell["config"])["name"] == "throwaway-cfg"
    assert reg.traffic(cell["traffic"])["clients"] == 2
    assert reg.metric("throwaway_metric").read(None) == 7.0
    assert reg.roofline("throwaway_kernel").launches(None) == [(1.0, 2.0)]
    names = {m["name"] for m in reg.metrics_for("throwaway.cell", True)}
    assert "throwaway_metric" in names
