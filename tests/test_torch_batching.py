"""Query and write coalescing of the port's service
(tpuvdb_torch/api/batching.py) against the JAX package's.

Mirrors tests/test_batching.py on device="cpu": concurrent searches share
one engine batch and return what direct searches return; concurrent
single-record puts share WAL group commits and all land. Adds the parity
of concurrent served searches with a JAX DBService (search_mode "exact").
The JAX service's native library is switched off (the reference's build
races between test workers).
"""

import threading
import time

import numpy as np
import pytest

from tpuvdb import native as jax_native
from tpuvdb.api.service import DBService as JaxService
from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb_torch.api.batching import BatchingSearcher
from tpuvdb_torch.api.service import DBService
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.core.types import VectorData

JOIN_S = 60


@pytest.fixture(autouse=True)
def _no_reference_build(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)


def _cfg(cls=DBConfig, **kw):
    return cls(**dict(dict(vector_dim=16, shard_count=2, shard_capacity=2048,
                           block_size=128), **kw))


def _run_threads(fn, n):
    errs = []

    def one(i):
        try:
            fn(i)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a request thread hung"
    assert not errs, errs


def test_batched_searches_match_direct(rng):
    svc = DBService(_cfg(), device="cpu")
    vecs = {}
    batch = []
    for i in range(100):
        v = rng.standard_normal(16).astype(np.float32)
        vecs[f"k{i}"] = v
        batch.append(VectorData(key=f"k{i}", vector=v))
    svc.engine.put_batch(batch)
    svc.engine.flush()

    searches_before = svc.engine.stats["searches"]
    results = {}

    def one(i):
        results[i] = svc.rpc_search({"query_vector": vecs[f"k{i}"].tolist(),
                                     "top_k": 3})

    _run_threads(one, 24)
    for i in range(24):
        r = results[i]
        assert r["success"], r
        assert r["search_result"]["keys"][0] == f"k{i}"
        assert r["search_result"]["scores"][0] < 1e-3
        assert len(r["search_result"]["keys"]) == 3
    # coalescing happened: far fewer engine searches than requests
    assert svc.engine.stats["searches"] - searches_before < 24
    assert svc.rpc_info({})["info"]["batcher_fallbacks"] == 0
    svc.close()


def test_concurrent_puts_group_commit(rng, tmp_path):
    """Concurrent single-record rpc_puts share WAL flush windows (far
    fewer fsync-bearing WAL writes than records) and every record lands
    durably and searchably."""
    from tpuvdb_torch.store import wal as wal_mod

    svc = DBService(_cfg(wal_enabled=True), data_dir=str(tmp_path / "db"),
                    device="cpu")
    writes = []
    real = wal_mod.WriteAheadLog._write_locked

    def spy(self, data):
        writes.append(len(data))
        return real(self, data)

    wal_mod.WriteAheadLog._write_locked = spy
    try:
        n = 64
        vecs = {i: rng.standard_normal(16).astype(np.float32)
                for i in range(n)}

        def one(i):
            r = svc.rpc_put({"key": f"k{i}", "vector": vecs[i].tolist()})
            assert r["success"], r

        # stall the writer's first apply under the engine lock so every put
        # enqueues before the drain
        threads = []
        with svc.engine._lock:
            for i in range(n):
                t = threading.Thread(target=one, args=(i,))
                t.start()
                threads.append(t)
            time.sleep(0.3)
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        assert len(writes) <= n // 3, f"{len(writes)} WAL writes for {n} puts"
    finally:
        wal_mod.WriteAheadLog._write_locked = real
    assert svc.engine.count() == n
    r = svc.rpc_search({"query_vector": vecs[5].tolist(), "top_k": 1})
    assert r["search_result"]["keys"] == ["k5"]
    svc.close()


def test_searcher_pads_k_and_truncates_per_caller(rng):
    """Mixed k in one drained batch: the batch runs at the largest k and
    each caller gets its own k."""
    svc = DBService(_cfg(search_mode="exact"), device="cpu")
    data = rng.standard_normal((50, 16)).astype(np.float32)
    svc.engine.put_rows([f"r{i}" for i in range(50)], data)
    b = BatchingSearcher(svc.engine, max_wait_s=0.05)
    out = {}

    def one(i):
        out[i] = b.search(data[i], 2 + i % 3, timeout=JOIN_S)

    _run_threads(one, 9)
    for i in range(9):
        d, keys = out[i]
        want_d, want_k = svc.engine.search_batch(data[i:i + 1], 2 + i % 3)
        assert list(keys) == want_k[0][:2 + i % 3]
        np.testing.assert_allclose(d, want_d[0][:2 + i % 3], rtol=1e-5,
                                   atol=1e-5)
    b.close()
    svc.close()


@pytest.mark.parametrize("coalesce", [False, True])
def test_concurrent_served_searches_equal_jax(coalesce, rng):
    """24 concurrent rpc_search calls and 8 concurrent search_batch calls
    through a port DBService give the JAX DBService's answers."""
    kw = dict(search_mode="exact", search_coalesce=coalesce)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    queries = data[:24] + 0.05 * rng.standard_normal((24, 16)).astype(
        np.float32)
    keys = [f"r{i}" for i in range(300)]
    jax_svc = JaxService(_cfg(JaxConfig, **kw))
    svc = DBService(_cfg(**kw), device="cpu")
    try:
        for s in (jax_svc, svc):
            assert s.engine.put_rows(keys, data).success
        got, got_b = {}, {}

        def one(i):
            got[i] = svc.rpc_search({"query_vector": queries[i].tolist(),
                                     "top_k": 5})

        def one_batch(i):
            got_b[i] = svc.rpc_search_batch(
                {"query_vectors": queries[3 * i:3 * i + 3].tolist(),
                 "top_k": 4})

        _run_threads(one, 24)
        _run_threads(one_batch, 8)
        for i in range(24):
            want = jax_svc.rpc_search({"query_vector": queries[i].tolist(),
                                       "top_k": 5})
            assert got[i]["search_result"]["keys"] == \
                want["search_result"]["keys"]
            np.testing.assert_allclose(got[i]["search_result"]["scores"],
                                       want["search_result"]["scores"],
                                       rtol=1e-5, atol=1e-5)
        for i in range(8):
            want = jax_svc.rpc_search_batch(
                {"query_vectors": queries[3 * i:3 * i + 3].tolist(),
                 "top_k": 4})
            assert [r["keys"] for r in got_b[i]["results"]] == \
                [r["keys"] for r in want["results"]]
        groups = svc.rpc_info({})["info"]["search_groups"]
        assert (groups is not None) == coalesce
    finally:
        jax_svc.close()
        svc.close()
