"""Whole runs of every cell at a tiny size on the CPU (the program's plain
twins in place of its kernels), the result line's schema, the isolation
check, and the command's refusal without a card."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from perfbench.harness import run_cell
from perfbench.isolation import forbidden_loaded
from perfbench.registry import REPO
from perfbench.tests.tiny import cells, tiny_registry

SEED = 2 ** 31 + 977  # above 32 signed bits: the command takes any seed


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny_registry(str(tmp_path_factory.mktemp("tiny")))


def check_schema(res, reg, cell, trace):
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = {m["name"]: m["unit"] for m in reg.metrics_for(cell, trace)}
    for name, m in res["metrics"].items():
        assert m["unit"] == want[name] and math.isfinite(m["value"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for part in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][part]) <= 10
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_correct_on_cpu(reg, cell, trace):
    res = run_cell(cell, SEED, 0.5, trace, device="cpu", registry=reg)
    check_schema(res, reg, cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = set(res["metrics"])
    if not trace:
        assert names == {m["name"] for m in reg.metrics_for(cell, False)}
    else:
        assert "index_device_gib" in names


def test_same_seed_same_inputs(reg):
    """The corpus is the configuration's; the seed draws the queries, each
    seed the same number around each centre."""
    from perfbench.corpus import make_corpus, make_queries, seed_streams
    cfg = reg.config(reg.workload(cells()[0])["config"])
    a, cents = make_corpus(cfg["corpus"], "cpu")
    b, _ = make_corpus(cfg["corpus"], "cpu")
    assert (a == b).all()
    q = [make_queries(cents, 64, 0.4, True, seed_streams(s)[0])
         for s in (SEED, SEED, SEED + 1)]
    assert (q[0] == q[1]).all() and not (q[0] == q[2]).all()
    near = [np.sort(np.argmax(x @ cents.numpy().T, axis=1)) for x in q]
    assert (near[0] == near[2]).all()  # the same mix of centres


def test_two_clients_share_the_window(reg, tmp_path):
    reg.traffic("closed-b1")  # the mix the throwaway copy starts from
    path = os.path.join(reg.root, "traffic", "closed-b1.json")
    mix = json.load(open(path))
    try:
        json.dump({**mix, "clients": 2}, open(path, "w"))
        res = run_cell("flat-f32-1m.b1", SEED, 0.5, False, device="cpu",
                       registry=reg)
    finally:
        json.dump(mix, open(path, "w"))
    assert res["correct"] and res["attempted"] > 2


def test_forbidden_names_compare_whole_top_level():
    names = ["tpuvdb_torch", "tpuvdb_torch.engine", "jaxtyping", "numpy",
             "tpuvdb", "tpuvdb.engine.engine", "jax.numpy", "jaxlib", "flax"]
    assert forbidden_loaded(names) == sorted(
        ["tpuvdb", "tpuvdb.engine.engine", "jax.numpy", "jaxlib", "flax"])


def test_a_run_loads_nothing_forbidden(tmp_path):
    """A whole tiny run in a fresh process leaves no JAX module and no
    module of the JAX package in sys.modules."""
    code = (
        "import sys, tempfile\n"
        "from perfbench.tests.tiny import tiny_registry, cells\n"
        "from perfbench.harness import run_cell\n"
        "from perfbench.isolation import forbidden_loaded\n"
        f"reg = tiny_registry({str(tmp_path)!r})\n"
        "for c in cells():\n"
        "    assert run_cell(c, 5, 0.2, True, device='cpu',"
        " registry=reg)['correct']\n"
        "print('FOUND', forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path does not run")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         cells()[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_sources_import_nothing_forbidden():
    """No file of the benchmark imports JAX or the JAX package, and the
    reference imports nothing of the program either: only its own
    modules beside the libraries."""
    import ast
    root = os.path.join(REPO, "perfbench")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            tree = ast.parse(open(path).read())
            tops = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops |= {a.name for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module:
                    tops.add(node.module)
            assert not forbidden_loaded(tops), path
            if os.path.basename(dirpath) == "reference":
                own = {t for t in tops if t.startswith("perfbench.reference.")}
                assert {t.split(".")[0] for t in tops - own} <= {
                    "__future__", "contextlib", "typing", "numpy", "torch"
                }, (path, tops)
