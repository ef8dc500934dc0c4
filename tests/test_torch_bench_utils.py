"""The port's benchmark helpers (tpuvdb_torch.bench.{datasets,recall,
harness}) against the JAX package's: the same files, seeds and ids give
the same arrays and the same recall, exactly."""

import struct

import numpy as np
import pytest
import torch

from tpuvdb.bench import datasets as jax_datasets
from tpuvdb.bench import recall as jax_recall
from tpuvdb_torch.bench import datasets, recall
from tpuvdb_torch.bench.harness import chained_timer


def _write_vecs(path, rows, dim):
    with open(path, "wb") as f:
        for row in rows:
            f.write(struct.pack("<i", dim))
            f.write(row.tobytes())


@pytest.mark.parametrize("max_rows", [None, 3, 50])
def test_fvecs_equal_to_reference(tmp_path, rng, max_rows):
    data = rng.standard_normal((10, 4)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    _write_vecs(path, data, 4)
    got = datasets.load_fvecs(path, max_rows)
    want = jax_datasets.load_fvecs(path, max_rows)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data[:max_rows])


@pytest.mark.parametrize("max_rows", [None, 4])
def test_bvecs_equal_to_reference(tmp_path, rng, max_rows):
    data = rng.integers(0, 255, (7, 8), dtype=np.uint8)
    path = str(tmp_path / "x.bvecs")
    _write_vecs(path, data, 8)
    got = datasets.load_bvecs(path, max_rows)
    want = jax_datasets.load_bvecs(path, max_rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data[:max_rows].astype(np.float32))


def test_sift1m_if_available_equal_to_reference(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("TPUVDB_DATASET_DIR", str(tmp_path))
    assert datasets.sift1m_if_available() is None
    assert jax_datasets.sift1m_if_available() is None
    (tmp_path / "sift").mkdir()
    base = rng.standard_normal((20, 4)).astype(np.float32)
    qry = rng.standard_normal((5, 4)).astype(np.float32)
    _write_vecs(str(tmp_path / "sift" / "sift_base.fvecs"), base, 4)
    _write_vecs(str(tmp_path / "sift" / "sift_query.fvecs"), qry, 4)
    got = datasets.sift1m_if_available(12)
    want = jax_datasets.sift1m_if_available(12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (12, 4) and got[1].shape == (5, 4)


@pytest.mark.parametrize("kw", [
    {"n": 1000, "dim": 16, "clustered": True, "n_clusters": 8},
    {"n": 500, "dim": 8, "seed": 3, "clustered": True, "spread": 0.1},
    {"n": 100, "dim": 8},
    {"n": 64, "dim": 12, "seed": 7},
])
def test_synthetic_corpus_equal_to_reference(kw):
    c, q = datasets.synthetic_corpus(**kw)
    jc, jq = jax_datasets.synthetic_corpus(**kw)
    assert c.shape == (kw["n"], kw["dim"]) and q.shape == (1024, kw["dim"])
    assert c.dtype == q.dtype == np.float32
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(q, jq)


def test_recall_at_k_equal_to_reference(rng):
    oracle = np.array([[1, 2, 3], [4, 5, 6]])
    got = np.array([[1, 2, 9], [4, -1, -1]])
    assert abs(recall.recall_at_k(got, oracle) - 3 / 6) < 1e-9
    for _ in range(5):
        o = rng.integers(0, 50, (16, 10))
        g = np.where(rng.random((16, 10)) < 0.2, -1,
                     rng.integers(0, 50, (16, 10)))
        assert recall.recall_at_k(g, o) == jax_recall.recall_at_k(g, o)


def test_recall_curve_equal_to_reference(rng):
    """A knob that widens a noisy exact scan: both packages' curves are
    the same dict, rising to 1 at no noise."""
    corpus = rng.standard_normal((400, 8)).astype(np.float32)
    valid = rng.random(400) > 0.1
    queries = corpus[:24] + 0.01 * rng.standard_normal((24, 8)).astype(
        np.float32)
    noise = rng.standard_normal((24, 400))

    def search_fn(q, k, knob):
        d = ((q[:, None, :] - corpus[None]) ** 2).sum(-1) + noise / knob
        d = np.where(valid[None], d, np.inf)
        return np.argsort(d, axis=1, kind="stable")[:, :k]

    sweep = [1, 10, 1e9]
    got = recall.recall_curve(search_fn, queries, corpus, valid, 5, sweep)
    want = jax_recall.recall_curve(search_fn, queries, corpus, valid, 5,
                                   sweep)
    assert got == want
    assert got[1e9] == 1.0 and got[1] < got[1e9]


@pytest.mark.parametrize("iters,reps", [(4, 1), (3, 2)])
def test_chained_timer_on_the_cpu(iters, reps):
    """Seconds per call on the host clock, one warm call first."""
    calls = []
    x = torch.ones(64, 64)

    def fn(a, b):
        calls.append(1)
        return a @ b

    dt = chained_timer(fn, (x, x), iters=iters, reps=reps)
    assert dt > 0
    assert len(calls) == 1 + iters * reps


def test_chained_timer_raises_on_a_window_that_is_not_positive(monkeypatch):
    """A clock that does not move gives a window of 0 s: the timer raises
    (the reference clamps it to 1e-9 s and a bench would publish it)."""
    from tpuvdb_torch.bench import harness

    monkeypatch.setattr(harness.time, "perf_counter", lambda: 5.0)
    x = torch.ones(4, 4)
    with pytest.raises(RuntimeError, match="not positive|took 0.0 s"):
        chained_timer(lambda a: a + 1, (x,), iters=2, reps=1)
