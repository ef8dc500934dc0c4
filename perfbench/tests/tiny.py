"""A registry of the benchmark's cells at a size a CPU test can hold: the
real BENCHMARK.json, metric readers, roofline counts and reference, with
each configuration cut to a few thousand rows of 32 elements and each mix
to a small pool and sample; a durable configuration checkpoints every 100
puts and a writer's mix writes 200 a second."""

from __future__ import annotations

import json
import os

import torch

from perfbench.registry import REPO, ROOT, Registry

ROWS, DIM, CLUSTERS = 6000, 32, 16


def tiny_registry(tmp: str) -> Registry:
    # a few intra-op threads a test process: tests run side by side, and
    # oversubscribed threads stretch a b1 call of a tiny window to ~1 s
    torch.set_num_threads(min(2, torch.get_num_threads()))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for kind in ("metrics", "roofline", "reference"):
        os.symlink(os.path.join(ROOT, kind), os.path.join(tmp, kind))
    os.makedirs(os.path.join(tmp, "traffic"))
    os.makedirs(os.path.join(tmp, "configs"))
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg["corpus"].update(rows=ROWS, dim=DIM, clusters=CLUSTERS)
        cfg["dbconfig"]["vector_dim"] = DIM
        if cfg["dbconfig"]["index_type"] == "ivf":
            cfg["dbconfig"].update(ivf_nlist=32, ivf_nprobe=8,
                                   ivf_train_sample=4096)
        if cfg.get("durability"):
            # checkpoints and a WAL tail within a tiny run's writes
            cfg["dbconfig"]["checkpoint_every_puts"] = 100
        c["file"] = os.path.join("configs", c["name"] + ".json")
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "traffic", w["traffic"] + ".json")) as f:
            t = json.load(f)
        t.update(pool_queries=256, check_queries=64, warm_calls=2)
        if t.get("writers"):
            # a run's deletes at 51 s stay under the tiny base rows
            t.update(write_rate=200, warm_writes=120)
        with open(os.path.join(tmp, "traffic", w["traffic"] + ".json"),
                  "w") as f:
            json.dump(t, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return Registry(root=tmp, repo=tmp)


def cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
