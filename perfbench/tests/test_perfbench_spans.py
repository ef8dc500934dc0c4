"""The readers of the program's spans and set-up stages
(perfbench/spans.py, perfbench/metrics/{search_keys_ms, index_host_ms,
index_wait_ms, search_tail_host_ms, put_rows_s, index_build_s}.py): a
traced tiny run of every cell on the CPU reports all six and stays
correct; on a program without spans (no `spans` entry, stages without
`total_ms`) each returns None and raises nothing."""

import pytest

from perfbench.harness import run_cell
from perfbench.tests.tiny import cells, tiny_registry

SEED = 2 ** 31 + 4093
SPAN_METRICS = ["search_keys_ms", "index_host_ms", "index_wait_ms",
                "search_tail_host_ms", "put_rows_s", "index_build_s"]


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny_registry(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", cells())
def test_traced_run_reports_every_span_metric(reg, cell):
    logged = []
    writes = reg.traffic(reg.workload(cell)["traffic"]).get("writers")
    # the CPU profiler's start holds a window's first ~0.8 s; a write
    # cell's b1 calls need the rest to sample some dozens
    res = run_cell(cell, SEED, 2.0 if writes else 0.5, True, device="cpu",
                   registry=reg, log=logged.append)
    assert res["correct"], res["checks"]
    wanted = {m["name"] for m in reg.metrics_for(cell, True)}
    for name in SPAN_METRICS:
        if name not in wanted:
            continue  # not among the metrics the cell reports
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] > 0, name
    if "search_tail_host_ms" in wanted:
        assert any("beyond the p95" in line for line in logged)
    assert any(line.startswith("index.build ") for line in logged)
    # staged deletes send a write-mixed cell's searches down the slow path
    assert any(("slow path " in line) if writes else ("slow path 0 of" in line)
               for line in logged)


class _OlderRun:
    """What a reader sees of a program older than the spans."""
    info = {"latency": {"search.device": {"count": 9, "p50_ms": 1.0,
                                          "p95_ms": 1.0, "mean_ms": 1.0}},
            "stats": {}}

    @staticmethod
    def log(msg):
        raise AssertionError(f"logged {msg!r}")


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_returns_none_without_spans(reg, name):
    assert reg.metric(name).read(_OlderRun()) is None
