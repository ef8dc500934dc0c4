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
    res = run_cell(cell, SEED, 0.5, True, device="cpu", registry=reg,
                   log=logged.append)
    assert res["correct"], res["checks"]
    for name in SPAN_METRICS:
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] > 0, name
    assert any("beyond the p95" in line for line in logged)
    assert any(line.startswith("index.build ") for line in logged)
    assert any("slow path 0 of" in line for line in logged)


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
