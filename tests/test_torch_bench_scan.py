"""The port's scan benchmark (tpuvdb_torch/bench/scan.py, with
bench/engine_serving.py) against the JAX package's (tpuvdb/bench/scan.py)
on the same small data, on the CPU.

Shape: 8,192 seeded gaussian rows x 32 and 512 queries, handed to both
`main`s through `sift1m_if_available` (tpuvdb/bench/scan.py:57-64). The
reference's IVF engine then asks for nlist 1024 = 8,192 / 8 and builds
without error, and both pad the corpus to 65,536 rows. The reference runs
once (a module fixture: its timing loops take most of this file's time);
the port's timing loops are cut to one window of one call and its engines
to a few searches, which change no recall.

Compared, with these tolerances:
* the last line's key set, equal, and `corpus` equal; each path's and the
  engine's `batch` equal (the headline `batch` is that of the fastest path,
  a timing, so it is held to its own path in each run);
* the int8, int8_b128 and int8_rescored recalls within 1/640 (one hit of
  64 queries x 10);
* approx_bf16 and engine_recall_at_10, each >= 0.95 in both runs and within
  0.02 of the reference's (JAX's approx_max_k is exact on the CPU, the
  port's "approx" is the 512-bucket scan);
* the port's capacity_pq is None, and its stdout has one line per stage
  (six paths, "engine", "ivf") before the last.

`load_corpus` draws the queries after the corpus from the same
default_rng(0), and takes SIFT1M's rows and queries where it is at hand.
The adversarial corpus: the port's `adversarial_corpus(1_000_000,
128, default_rng(0))` equals, bit for bit, the rows the reference's `main`
draws, recorded from its first call of `quantize_rows_np` (right after the
draw and the padding) without editing the reference.
"""

import contextlib
import functools
import io
import json

import numpy as np
import pytest

import tpuvdb.bench.datasets as jax_datasets
import tpuvdb.bench.scan as jax_scan
import tpuvdb.kernels.quant as jax_quant
from tpuvdb_torch.bench import datasets, engine_serving, harness, scan

N, DIM = 8192, 32
PATHS = ["approx_bf16", "int8", "int8_b128", "int8_rescored", "pallas_bf16",
         "pallas_bf16_b512"]
REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "recall_at_10",
                  "best_path", "batch", "corpus", "dataset", "paths",
                  "engine", "capacity_pq"}
ONE_HIT = 1 / 640


def _small_data():
    rng = np.random.default_rng(1234)
    corpus = rng.standard_normal((N, DIM)).astype(np.float32)
    queries = rng.standard_normal((512, DIM)).astype(np.float32)
    return corpus, queries


def _stdout_lines(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def quick_port_bench(mp):
    """Cuts the port's timing loops to one window of one call and its
    engines to a few searches (recall and the keys stay)."""
    timer = harness.chained_timer
    mp.setattr(harness, "chained_timer",
               lambda fn, args, iters=20, reps=3: timer(fn, args, 1, 1))
    mp.setattr(engine_serving, "run_engine_serving", functools.partial(
        engine_serving.run_engine_serving, iters=2, threads=2))
    mp.setattr(engine_serving, "run_ivf_small_batch", functools.partial(
        engine_serving.run_ivf_small_batch, iters=3))


@pytest.fixture(scope="module")
def runs():
    data = _small_data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_datasets, "sift1m_if_available",
                   lambda max_rows=None: data)
        mp.setattr(datasets, "sift1m_if_available",
                   lambda max_rows=None: data)
        want = _stdout_lines(jax_scan.main)
        quick_port_bench(mp)
        got = _stdout_lines(scan.main, device="cpu")
    return want[-1], got


def test_last_line_has_the_reference_keys(runs):
    want, got = runs
    line = got[-1]
    assert set(want) == REFERENCE_KEYS
    assert set(line) == set(want)
    assert line["metric"] == want["metric"]
    assert line["corpus"] == want["corpus"] == [N, DIM]
    assert line["capacity_pq"] is None
    for run in (want, line):
        assert run["batch"] == run["paths"][run["best_path"]]["batch"]
        assert run["recall_at_10"] == \
            run["paths"][run["best_path"]]["recall_at_10"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / 50_000)


def test_one_line_per_stage_before_the_last(runs):
    _, got = runs
    stages = [line["stage"] for line in got[:-1]]
    assert stages == PATHS + ["engine", "ivf"]
    line = got[-1]
    for stage in got[:len(PATHS)]:
        name = stage.pop("stage")
        assert stage == line["paths"][name]
        assert stage["qps"] > 0 and stage["batch_latency_ms"] > 0
    engine = {**got[-3], **got[-2]}
    del engine["stage"]
    assert engine == line["engine"]


@pytest.mark.parametrize("path", ["int8", "int8_b128", "int8_rescored"])
def test_int8_recall_within_one_hit(runs, path):
    want, got = runs
    g, w = got[-1]["paths"][path], want["paths"][path]
    assert g["batch"] == w["batch"]
    assert abs(g["recall_at_10"] - w["recall_at_10"]) <= ONE_HIT + 1e-9


def test_approx_and_engine_recall(runs):
    want, got = runs
    line = got[-1]
    pairs = [(line["paths"]["approx_bf16"]["recall_at_10"],
              want["paths"]["approx_bf16"]["recall_at_10"]),
             (line["engine"]["engine_recall_at_10"],
              want["engine"]["engine_recall_at_10"])]
    for g, w in pairs:
        assert g >= 0.95 and w >= 0.95
        assert abs(g - w) <= 0.02
    assert line["engine"]["batch"] == want["engine"]["batch"] == 512
    assert line["engine"]["ivf_batch"] == want["engine"]["ivf_batch"] == 8
    assert "error" not in want["engine"]
    assert set(line["engine"]) == set(want["engine"])
    # the scan paths recall as the approx path does: the same kernel
    for p in ("pallas_bf16", "pallas_bf16_b512"):
        assert line["paths"][p]["recall_at_10"] == \
            line["paths"]["approx_bf16"]["recall_at_10"]


def test_load_corpus_draws_the_queries_after_the_corpus(monkeypatch):
    """Without SIFT1M: the adversarial corpus, then 512 gaussian queries
    from the same default_rng(0), as tpuvdb/bench/scan.py:78-103 draws
    them."""
    monkeypatch.setattr(datasets, "sift1m_if_available",
                        lambda max_rows=None: None)
    corpus, queries, note = scan.load_corpus(5000, 8)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        corpus, datasets.adversarial_corpus(5000, 8, rng))
    np.testing.assert_array_equal(
        queries, rng.standard_normal((512, 8)).astype(np.float32))
    assert note.startswith("synthetic-adversarial")


@pytest.mark.parametrize("n_queries", [600, 100])
def test_load_corpus_takes_sift1m(monkeypatch, n_queries):
    """With SIFT1M: its rows, and its first 512 queries where it has that
    many, else 512 gaussian queries of default_rng(0)."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((300, 8)).astype(np.float32)
    qry = rng.standard_normal((n_queries, 8)).astype(np.float32)
    monkeypatch.setattr(datasets, "sift1m_if_available",
                        lambda max_rows=None: (base, qry))
    corpus, queries, note = scan.load_corpus()
    assert corpus is base and note == "real SIFT1M 300x8"
    want = (qry[:512] if n_queries >= 512 else np.random.default_rng(
        0).standard_normal((512, 8)).astype(np.float32))
    np.testing.assert_array_equal(queries, want)


class _Drawn(Exception):
    pass


def test_adversarial_corpus_is_the_references_draw(monkeypatch):
    drawn = {}

    def record(padded):
        drawn["padded"] = padded
        raise _Drawn

    monkeypatch.setattr(jax_datasets, "sift1m_if_available",
                        lambda max_rows=None: None)
    monkeypatch.setattr(jax_quant, "quantize_rows_np", record)
    try:
        jax_scan.main()
    except _Drawn:
        pass
    padded = drawn.pop("padded")
    n = 1_000_000
    assert padded.shape == (1 << 20, 128)
    assert not padded[n:].any()
    got = datasets.adversarial_corpus(n, 128, np.random.default_rng(0))
    assert got.dtype == np.float32 and got.shape == (n, 128)
    np.testing.assert_array_equal(got, padded[:n])
