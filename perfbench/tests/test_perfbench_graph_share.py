"""The reader of the IVF probe graphs' share (perfbench/metrics/
ivf_graph_share.py): replays over every search the index counted, from the
engine's `ivf_graph_*` counters; None on a program without them or where
the index counted no search; a traced tiny run of the IVF cell on the CPU,
where every probe is eager, reads 0 and stays correct."""

import pytest

from perfbench.harness import run_cell
from perfbench.registry import Registry
from perfbench.tests.tiny import tiny_registry

SEED = 2 ** 31 + 8191
READ = Registry().metric("ivf_graph_share").read


class _Run:
    def __init__(self, stats):
        self.info = {"stats": stats}
        self.logged = []

    def log(self, line):
        self.logged.append(line)


def _stats(replays, **eager):
    return {"searches": 9, "ivf_graph_replays": replays,
            "ivf_graph_captures": 1 if replays else 0,
            **{f"ivf_graph_eager_{r}": n for r, n in eager.items()}}


def test_share_of_replays_over_index_searches():
    run = _Run(_stats(99, cold=1, busy=0, filtered=0))
    assert READ(run) == pytest.approx(0.99)
    assert "99 replays of 100 index searches" in run.logged[0]


@pytest.mark.parametrize("stats", [{"searches": 9}, {}, _stats(0, cold=0)])
def test_none_without_counters_or_searches(stats):
    assert READ(_Run(stats)) is None


def test_traced_tiny_ivf_run_reads_zero_on_the_cpu(tmp_path):
    reg = tiny_registry(str(tmp_path))
    res = run_cell("ivf-f32-1m.b256", SEED, 0.5, True, device="cpu",
                   registry=reg)
    assert res["correct"], res["checks"]
    assert res["metrics"]["ivf_graph_share"]["value"] == 0.0
