"""The port's spans and stages (tpuvdb_torch/utils/tracing.py) and where
the engine, the indexes and the probe place them.

* With no profiler running, `span()` (the timer's and the module's) hands
  back the shared no-op and records nothing.
* Under torch.profiler (CPU activity), a search on a small flat engine and
  a small IVF engine puts every span of the search path inside its own
  `search.call` range as CPU kineto events (`index.plan` on IVF only);
  `info()["spans"]` totals agree with those events' durations within 5%,
  plus 1 us a span: the program reads its clock just after the range opens
  and just after it closes, so a span's two ends sit up to ~0.5 us from
  the range's own timestamps (measured on the CPU, where `index.wait`
  copies nothing and lasts ~7 us); each self time is at most its total;
  the tail holds ceil(5%) of the calls.
* `snapshot()` reports `total_ms` over every sample and no `p99_ms`.
* A bulk load and a flush time `put_rows` (with `put_rows.route` and
  `put_rows.write`) and `index.build` (with `build.upload` on a flat
  index; `build.train`, `build.assign`, `build.split`, `build.pack` and
  `build.upload` on IVF) once each.
* `stats["search_slow_path"]` rises when a staged delete puts a dead row
  among a call's hits; `stats["search_queries"]` counts query rows.
* A profiled session's calls are kept until the next session begins: a
  read of the spans with no profiler running ends it, and the next traced
  block starts one afresh.
* The cost bench prices a block and, in its window, keeps spans in just
  the settings that time them.
"""

import math
import time

import numpy as np
import pytest
import torch

from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.utils import tracing
from tpuvdb_torch.utils.tracing import StageTimer

DIM = 16
ROWS = 4096
CALLS = 40
SEARCH_SPANS = ["search.snapshot", "search.device", "index.upload",
                "index.launch", "index.wait", "index.row_map",
                "search.assemble", "search.keys"]


def _engine(index_type: str) -> VectorDBEngine:
    return VectorDBEngine(DBConfig(
        vector_dim=DIM, shard_count=2, shard_capacity=8192,
        index_type=index_type, ivf_nlist=16, ivf_nprobe=4,
        ivf_kmeans_iters=3, wal_enabled=False,
        checkpoint_every_puts=10 ** 9, compact_every_puts=10 ** 9,
        search_coalesce=True), device="cpu")


def _loaded(index_type: str, rng):
    eng = _engine(index_type)
    data = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    assert eng.put_rows([f"k{i}" for i in range(ROWS)], data).success
    eng.flush()
    return eng, data


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.events()


@pytest.mark.parametrize("owner", ["timer", "module"])
def test_span_without_a_profiler_is_the_shared_noop(owner):
    timer = StageTimer()
    with timer.stage("outer"):  # an open block, so the module's span has
        #                         a timer to join
        make = timer.span if owner == "timer" else tracing.span
        s = make("x")
        assert s is tracing._NOOP
        with s:
            pass
    assert timer.spans() is None
    assert set(timer.snapshot()) == {"outer"}


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_search_spans_nest_in_each_call(rng, index_type):
    eng, _ = _loaded(index_type, rng)
    q = rng.standard_normal((8, DIM)).astype(np.float32)
    eng.search_batch(q, 10)  # warm, unprofiled: records no span

    def calls():
        for _ in range(CALLS):
            eng.search_batch(q, 10)

    events = [e for e in _profiled(calls)
              if str(e.device_type()).endswith("CPU")]
    want = SEARCH_SPANS + (["index.plan"] if index_type == "ivf" else [])
    roots = [e for e in events if e.name() == "search.call"]
    assert len(roots) == CALLS
    spans = [e for e in events if e.name() in want]
    for root in roots:
        s0, s1 = root.start_ns(), root.start_ns() + root.duration_ns()
        inside = {e.name() for e in spans
                  if s0 <= e.start_ns()
                  and e.start_ns() + e.duration_ns() <= s1}
        assert inside == set(want)

    info = eng.info()["spans"]
    assert info["calls"] == CALLS
    names = info["names"]
    assert set(names) == set(want) | {"search.call"}
    for name, got in names.items():
        evs = [e for e in events if e.name() == name]
        ev_ms = sum(e.duration_ns() for e in evs) * 1e-6
        assert got["count"] == len(evs)
        assert abs(got["total_ms"] - ev_ms) <= 0.05 * ev_ms + 1e-3 * len(evs)
        assert 0.0 <= got["self_ms"] <= got["total_ms"]
    # the children account for the call
    assert names["search.call"]["self_ms"] < names["search.call"]["total_ms"]
    tail = info["tail"]
    assert tail["calls"] == math.ceil(0.05 * CALLS) and tail["of"] == CALLS
    assert set(tail["mean_ms"]) == set(want) | {"search.call"}
    assert tail["mean_ms"]["search.call"] >= tail["all_mean_ms"][
        "search.call"]
    eng.close()


def test_snapshot_has_totals_and_no_p99():
    timer = StageTimer(window=4)
    for _ in range(10):
        with timer.stage("s"):
            pass
    snap = timer.snapshot()["s"]
    assert "p99_ms" not in snap
    assert set(snap) == {"count", "total_ms", "p50_ms", "p95_ms", "mean_ms"}
    assert snap["count"] == 10
    # the total covers all 10 samples, the mean the newest 4
    assert snap["total_ms"] >= snap["mean_ms"] * 4 - 1e-3


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_set_up_stages_once_after_a_load_and_a_flush(rng, index_type):
    eng, _ = _loaded(index_type, rng)
    build = (["build.upload"] if index_type == "flat" else
             ["build.train", "build.assign", "build.split", "build.pack",
              "build.upload"])
    snap = eng.info()["latency"]
    for name in ["put_rows", "put_rows.route", "put_rows.write",
                 "index.build"] + build:
        assert snap[name]["count"] == 1, name
    parts = sum(snap[n]["total_ms"] for n in build)
    assert parts <= snap["index.build"]["total_ms"] + 1e-3
    assert (snap["put_rows.route"]["total_ms"]
            + snap["put_rows.write"]["total_ms"]
            <= snap["put_rows"]["total_ms"] + 1e-3)
    eng.close()


def test_slow_path_counter_rises_on_a_staged_delete(rng):
    eng, data = _loaded("flat", rng)
    eng.search_batch(data[:4], 5)
    stats = eng.info()["stats"]
    assert stats["search_slow_path"] == 0 and stats["search_queries"] == 4
    assert eng.delete("k3").success  # staged: its row stays on the device
    dists, keys = eng.search_batch(data[3:4], 5)
    stats = eng.info()["stats"]
    assert stats["search_slow_path"] == 1 and stats["search_queries"] == 5
    assert "k3" not in keys[0] and len(keys[0]) == 5
    eng.close()


def test_a_session_is_kept_until_the_next_begins(rng):
    eng, _ = _loaded("flat", rng)
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    _profiled(lambda: [eng.search_batch(q, 10) for _ in range(20)])
    first = eng.info()["spans"]
    assert first["calls"] == 20 and first["tail"]["calls"] == 1
    eng.search_batch(q, 10)  # unprofiled: records nothing
    assert len(eng.timers._calls) == 20
    assert eng.info()["spans"] == first
    _profiled(lambda: [eng.search_batch(q, 10) for _ in range(3)])
    second = eng.info()["spans"]
    assert second["calls"] == 3 and second["tail"]["of"] == 3
    eng.close()


def test_self_time_leaves_out_nested_blocks():
    timer = StageTimer()

    def call():
        with timer.span("root", root=True):
            time.sleep(0.004)
            with timer.stage("child"):
                with tracing.span("grandchild"):
                    time.sleep(0.008)

    _profiled(call)
    info = timer.spans()
    names = info["names"]
    total = {n: v["total_ms"] for n, v in names.items()}
    assert total["root"] >= 12.0 and total["grandchild"] >= 8.0
    assert names["root"]["self_ms"] == pytest.approx(
        total["root"] - total["child"])
    assert names["child"]["self_ms"] == pytest.approx(
        total["child"] - total["grandchild"])
    assert names["grandchild"]["self_ms"] == total["grandchild"]
    assert info["tail"]["mean_ms"]["grandchild"] == pytest.approx(
        names["grandchild"]["total_ms"])


def test_cost_bench_prices_a_call_on_the_cpu():
    from tpuvdb_torch.bench import tracing_cost

    costs = tracing_cost.block_costs(2000)
    assert 0 < costs["span_off_us"] < costs["span_on_us"]
    per = tracing_cost.blocks_per_call("ivf", "cpu", batch=2, rows=2048,
                                       calls=10)
    assert per["stages"] == 2 and per["spans"] == 9
    assert per["by_name"]["index.row_map"] == 2



@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_cost_bench_window_keeps_spans_only_where_they_run(index_type):
    from tpuvdb_torch.bench import tracing_cost

    out = tracing_cost.window_costs("cpu", rows=2048, batch=1,
                                    seconds=0.05, rounds=1,
                                    index_type=index_type)
    assert set(out) == set(tracing_cost.SETTINGS)
    kept = {"profiled, spans on", "profiled, keeping alone",
            "unprofiled, spans kept"}
    for name, row in out.items():
        assert row["calls"] > 0 and len(row["turn_means_ms"]) == 2, name
        assert row["search.device_ms"] > 0, name
        assert ("spans_ms_a_call" in row) == (name in kept), name
    assert out["untraced"]["over_untraced_ms"] == 0.0
    assert "index.launch" in out["unprofiled, spans kept"]["spans_ms_a_call"]
