"""Finds what belongs to one cell by the names in BENCHMARK.json.

Nothing about one configuration, mix or metric is written in the harness:
  a cell            an entry of BENCHMARK.json's `workloads`
  a configuration   the JSON file its `configs` entry names (`file`)
  a traffic mix     <root>/traffic/<name>.json
  a metric          <root>/metrics/<name>.py, whose read(run) returns its
                    value or None where it finds nothing to read
  a roofline count  <root>/roofline/<kernel>.py (KERNELS, MAIN, launches)
  a reference       <root>/reference/<name>.py, named by the configuration
so a new one is a new file (and an entry) and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)


class Registry:
    def __init__(self, root: str = ROOT, repo: str = REPO):
        self.root = root
        self.repo = repo
        with open(os.path.join(repo, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        self._modules: Dict[str, ModuleType] = {}

    @staticmethod
    def _named(entries: List[dict], name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named(self.bench["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.bench["configs"], name, "config")
        with open(os.path.join(self.repo, entry["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.root, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def _module(self, kind: str, name: str) -> ModuleType:
        path = os.path.join(self.root, kind, f"{name}.py")
        if path not in self._modules:
            if not os.path.isfile(path):
                raise KeyError(f"no {kind} module {path}")
            spec = importlib.util.spec_from_file_location(
                f"perfbench_{kind}.{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def roofline(self, kernel: str) -> ModuleType:
        return self._module("roofline", kernel)

    def reference(self, name: str) -> ModuleType:
        return self._module("reference", name)

    def metrics_for(self, cell: str, trace: bool) -> List[dict]:
        """The metric entries a run of `cell` reports: its end-to-end
        metrics with trace off, its per-layer metrics with trace on. A
        metric with `workloads` belongs to those cells; an end-to-end one
        without, to every cell; a per-layer one without, to every cell
        that reports the end-to-end metric it moves."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]
