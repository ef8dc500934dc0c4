"""tpuvdb_torch.VectorDBEngine with index_type="ivf" (on the CPU).

* The scenarios of tests/test_engine_ivf.py on the port's engine: delta
  inserts visible before and after flush, staged deletes do not eat top-k
  width, delta overflow drains by append instead of a rebuild, delete and
  overwrite, bounded search latency under concurrent ingest, a warm restart
  that skips k-means, and a retrain after heavy or churn-neutral drift.
* On clustered data, recall@10 of the port's engine and of the JAX engine
  against an exact scan are each >= 0.9 (the JAX engine on the CPU takes
  its XLA route, `_ivf_search`, so the two agree in recall, not row for
  row; row-for-row parity of the probe is in test_torch_ivf_index.py).
* A JAX IVF data_dir warm-restarts in the port (no k-means) with the same
  keys, and the other way round.
* The snapshot rule: an in-place write during a probe makes the search
  retry, and a delta row the probe also returned comes back once.
"""

import threading
import time

import numpy as np
import pytest

from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.core.types import SearchRequest, VectorData
from tpuvdb_torch.kernels.distance import numpy_oracle
from tpuvdb_torch.mesh import create_mesh

DIM = 16


def ivf_config(cls=DBConfig, **kw):
    d = dict(vector_dim=DIM, shard_count=4, shard_capacity=8192,
             block_size=128, index_type="ivf", ivf_nlist=8, ivf_nprobe=8,
             ivf_kmeans_iters=5, ivf_delta_max=64,
             checkpoint_every_puts=10_000, compact_every_puts=1_000_000)
    d.update(kw)
    return cls(**d)


def engine(data_dir=None, **kw):
    return VectorDBEngine(ivf_config(**kw), data_dir=data_dir, device="cpu")


def fill(eng, rng, n, prefix="k"):
    vecs = {}
    batch = []
    for i in range(n):
        v = rng.standard_normal(DIM).astype(np.float32)
        vecs[f"{prefix}{i}"] = v
        batch.append(VectorData(key=f"{prefix}{i}", vector=v))
    assert eng.put_batch(batch).success
    return vecs


def top(eng, q, k):
    r = eng.search(SearchRequest(query_vector=q, top_k=k))
    assert r.success
    return r.search_result


def test_ivf_engine_end_to_end(rng):
    eng = engine()
    vecs = fill(eng, rng, 400)
    res = top(eng, vecs["k123"], 5)
    assert res.keys[0] == "k123" and res.scores[0] < 1e-2
    info = eng.info()
    assert info["ivf"]["nlist"] >= 8 and info["device_bytes"] > 0


def test_ivf_staged_deletes_do_not_eat_topk_width(rng):
    eng = engine(flush_batch=1024)
    vecs = fill(eng, rng, 400)
    q = vecs["k42"]
    near = [f"n{i}" for i in range(10)]
    assert eng.put_batch([
        VectorData(key=nk, vector=q + 0.01 * rng.standard_normal(DIM)
                   .astype(np.float32)) for nk in near]).success
    eng.flush()
    for nk in near:
        assert eng.delete(nk).success  # staged only
    keys = top(eng, q, 10).keys
    assert len(keys) == 10 and not set(keys) & set(near)
    assert keys[0] == "k42"


def test_ivf_delta_inserts_visible(rng):
    eng = engine()
    fill(eng, rng, 300)
    eng.flush()
    v = rng.standard_normal(DIM).astype(np.float32)
    eng.put(VectorData(key="fresh", vector=v))
    assert top(eng, v, 1).keys == ["fresh"]
    assert eng.info()["staged"] == 1 and eng.info()["ivf_delta"] == 0
    eng.flush()
    assert eng.info()["staged"] == 0 and eng.info()["ivf_delta"] == 1
    assert top(eng, v, 1).keys == ["fresh"]


def test_ivf_delta_overflow_drains_into_the_index(rng):
    eng = engine(ivf_delta_max=16)
    fill(eng, rng, 200)
    eng.flush()
    fill(eng, rng, 50, prefix="d")
    eng.flush()
    assert eng.info()["ivf_delta"] == 0
    assert eng.stats["ivf_appends"] == 50
    q = eng.get("d25").vector_data.vector
    assert top(eng, q, 1).keys == ["d25"]


def test_ivf_delete_and_overwrite(rng):
    eng = engine()
    vecs = fill(eng, rng, 200)
    eng.flush()
    eng.delete("k10")
    assert "k10" not in top(eng, vecs["k10"], 3).keys
    v2 = rng.standard_normal(DIM).astype(np.float32)
    eng.put(VectorData(key="k11", vector=v2, metadata={"v": "2"}))
    assert top(eng, v2, 1).keys == ["k11"]
    res = top(eng, vecs["k11"], 2)
    if "k11" in res.keys:  # only as the new vector, at its distance
        old_d = float(np.sum((vecs["k11"] - v2) ** 2))
        assert abs(res.scores[res.keys.index("k11")] - old_d) < 1e-2
    eng.flush()  # the deletes reach the device
    assert "k10" not in top(eng, vecs["k10"], 3).keys
    assert eng.get("k11").vector_data.metadata == {"v": "2"}


def test_ivf_concurrent_ingest_search_bounded(rng):
    eng = engine()
    vecs = fill(eng, rng, 400)
    eng.flush()
    flushes0 = eng.stats["flushes"]
    stop = threading.Event()
    errors = []
    wrng = np.random.default_rng(1)

    def writer():
        i = 0
        while not stop.is_set():
            try:
                eng.put(VectorData(key=f"w{i}", vector=wrng.standard_normal(
                    DIM).astype(np.float32)))
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return
            i += 1
            time.sleep(0.001)

    t = threading.Thread(target=writer)
    t.start()
    try:
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            assert top(eng, vecs["k7"], 5).keys[0] == "k7"
            lat.append(time.perf_counter() - t0)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and not errors
    assert eng.stats["flushes"] - flushes0 < 10
    assert sorted(lat)[len(lat) // 2] < 1.0


def test_ivf_incremental_append_instead_of_rebuild(rng):
    eng = engine(ivf_delta_max=64)
    vecs = fill(eng, rng, 500)
    eng.flush()
    ivf = eng._ivf
    for wave in range(3):
        vecs.update(fill(eng, rng, 100, prefix=f"w{wave}_"))
        eng.flush()
    assert eng._ivf is ivf               # appended, never rebuilt
    assert eng.stats["ivf_appends"] > 0 and eng._generation > 0
    for key in ("k42", "w0_5", "w1_50", "w2_99"):
        res = top(eng, vecs[key], 3)
        assert res.keys[0] == key and res.scores[0] < 1e-2, key
    assert eng.delete("w1_50").success
    eng.flush()
    assert "w1_50" not in top(eng, vecs["w1_50"], 3).keys


def _clustered(rng, n=3000, n_clusters=24):
    centers = rng.standard_normal((n_clusters, DIM)).astype(np.float32) * 3
    data = centers[rng.integers(0, n_clusters, n)] + 0.4 * \
        rng.standard_normal((n, DIM)).astype(np.float32)
    q = data[rng.choice(n, 32, replace=False)] + 0.05 * \
        rng.standard_normal((32, DIM)).astype(np.float32)
    return data, q


def test_ivf_recall_of_port_and_jax_against_exact(rng):
    data, q = _clustered(rng)
    keys = [f"r{i}" for i in range(len(data))]
    kw = dict(ivf_nlist=24, ivf_nprobe=6, ivf_delta_max=10_000)
    port = engine(**kw)
    jax = JaxEngine(ivf_config(JaxConfig, **kw))
    _, truth = numpy_oracle(q, data, np.ones(len(data), bool), 10)
    for eng in (port, jax):
        assert eng.put_rows(keys, data).success
        _, got = eng.search_batch(q, 10)
        hit = sum(len({keys[i] for i in truth[r]} & set(got[r]))
                  for r in range(len(q)))
        assert hit / (10 * len(q)) >= 0.9, (type(eng).__module__, hit)


def test_ivf_filtered_search_on_device(rng):
    eng = engine(ivf_delta_max=10_000)
    eng._FILTER_DEVICE_MIN = 50
    data = rng.standard_normal((400, DIM)).astype(np.float32)
    assert eng.put_rows([f"k{i}" for i in range(400)], data,
                        metadatas=[{"g": str(i % 3)} for i in range(400)]
                        ).success
    eng.flush()
    v = data[4] + 0.01
    eng.put(VectorData(key="fresh", vector=v, metadata={"g": "1"}))
    eng.flush()  # "fresh" stands in the host delta
    r = eng.search(SearchRequest(query_vector=v, top_k=5,
                                 filter_metadata={"g": "1"}))
    keys = r.search_result.keys
    assert keys[:2] == ["fresh", "k4"] and len(keys) == 5
    assert all(k == "fresh" or int(k[1:]) % 3 == 1 for k in keys)


def _restart_cfg(cls=DBConfig):
    return ivf_config(cls, ivf_delta_max=10_000, checkpoint_every_puts=10**9)


def test_ivf_warm_restart_skips_kmeans_training(rng, tmp_path,
                                                monkeypatch):
    d = str(tmp_path / "db")
    eng = VectorDBEngine(_restart_cfg(), data_dir=d, device="cpu")
    vecs = fill(eng, rng, 400)
    eng.flush()
    cents = eng._ivf.centroids_np().copy()
    q = np.stack([vecs[f"k{i}"] for i in range(0, 400, 40)])
    want = eng.search_batch(q, 5)
    eng.close()

    import tpuvdb_torch.index.ivf as ivf_mod

    def no_training(*a, **k):
        raise AssertionError("k-means training ran on a warm restart")

    monkeypatch.setattr(ivf_mod, "kmeans", no_training)
    eng2 = VectorDBEngine(_restart_cfg(), data_dir=d, device="cpu")
    got = eng2.search_batch(q, 5)
    assert got[1] == want[1]
    np.testing.assert_array_equal(eng2._ivf.centroids_np(), cents)
    assert eng2._ivf_warm is None      # consumed once
    eng2.close()


@pytest.mark.parametrize("churn", ["shrink", "neutral"])
def test_ivf_warm_restart_retrains_after_drift(rng, tmp_path, churn):
    d = str(tmp_path / "db")
    eng = VectorDBEngine(_restart_cfg(), data_dir=d, device="cpu")
    vecs = fill(eng, rng, 400 if churn == "shrink" else 300)
    eng.flush()
    if churn == "shrink":  # live rows far below 0.5x of training
        for i in range(360):
            eng.delete(f"k{i}")
        probe = "k390"
    else:  # delete N + insert N: the live count stays, the churn counter
        for i in range(200):  # passes the training corpus size
            assert eng.delete(f"k{i}").success
            v = rng.standard_normal(DIM).astype(np.float32)
            vecs[f"r{i}"] = v
            assert eng.put(VectorData(key=f"r{i}", vector=v)).success
        probe = "r42"
    eng.close()

    import tpuvdb_torch.index.ivf as ivf_mod

    calls = []
    real = ivf_mod.kmeans

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    eng2 = VectorDBEngine(_restart_cfg(), data_dir=d, device="cpu")
    ivf_mod.kmeans = counting
    try:
        assert top(eng2, vecs[probe], 3).keys[0] == probe
        assert calls, "expected a retrain after drift"
    finally:
        ivf_mod.kmeans = real
        eng2.close()


def _write_ivf_dir(eng, rng):
    data, q = _clustered(rng, n=1200, n_clusters=12)
    assert eng.put_rows([f"x{i}" for i in range(len(data))], data).success
    eng.flush()
    eng.delete("x3")
    return q


def test_jax_ivf_data_dir_warm_restarts_in_port(rng, tmp_path, monkeypatch):
    d = str(tmp_path / "db")
    jeng = JaxEngine(_restart_cfg(JaxConfig), data_dir=d)
    q = _write_ivf_dir(jeng, rng)
    cents = jeng._ivf.centroids_np().copy()
    jeng.close()

    import tpuvdb_torch.index.ivf as ivf_mod

    monkeypatch.setattr(ivf_mod, "kmeans", None)  # any training would fail
    port = VectorDBEngine(_restart_cfg(), data_dir=d, device="cpu")
    _, keys = port.search_batch(q, 10)
    np.testing.assert_array_equal(port._ivf.centroids_np(), cents)
    assert all(k is not None and k != "x3" for row in keys for k in row)
    # the JAX engine rebuilt from the same centroids: the same cells, so
    # the same probe, except where its CPU route ranks differently
    jeng = JaxEngine(_restart_cfg(JaxConfig), data_dir=d)
    _, jkeys = jeng.search_batch(q, 10)
    same = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(keys, jkeys)])
    assert same >= 0.9, same
    jeng.close()
    port.close()


def test_port_ivf_data_dir_warm_restarts_in_jax(rng, tmp_path, monkeypatch):
    d = str(tmp_path / "db")
    port = VectorDBEngine(_restart_cfg(), data_dir=d, device="cpu")
    q = _write_ivf_dir(port, rng)
    cents = port._ivf.centroids_np().copy()
    _, want = port.search_batch(q, 10)
    port.close()

    import tpuvdb.index.ivf as jax_ivf_mod

    monkeypatch.setattr(jax_ivf_mod, "kmeans", None)
    jeng = JaxEngine(_restart_cfg(JaxConfig), data_dir=d)
    _, jkeys = jeng.search_batch(q, 10)
    np.testing.assert_array_equal(jeng._ivf.centroids_np(), cents)
    same = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(want, jkeys)])
    assert same >= 0.9, same
    jeng.close()
    # and back again, from the JAX engine's close() checkpoint
    port = VectorDBEngine(_restart_cfg(), data_dir=d, device="cpu")
    assert port.search_batch(q, 10)[1] == want
    port.close()


def test_ivf_write_during_probe_retries(rng):
    """An in-place write (here a delete flushed by another thread) that
    lands while a probe runs bumps IVFIndex.version: the search retries
    and returns the post-write state."""
    eng = engine()
    vecs = fill(eng, rng, 300)
    eng.flush()
    ivf = eng._ivf
    real = ivf.search
    fired = []

    def search_with_a_write(*a, **kw):
        out = real(*a, **kw)
        if not fired:
            fired.append(1)
            eng.delete("k5")
            eng.flush()
        return out

    ivf.search = search_with_a_write
    keys = top(eng, vecs["k5"], 3).keys
    assert fired and eng.stats["search_retries"] >= 1
    assert "k5" not in keys


def test_ivf_delta_row_on_device_comes_back_once(rng):
    """A delta row that the device probe also returned (an append that
    landed before the probe while the row is still in the snapshot's
    delta) is scored once."""
    eng = engine(ivf_delta_max=10_000)
    fill(eng, rng, 300)
    eng.flush()
    v = rng.standard_normal(DIM).astype(np.float32)
    eng.put(VectorData(key="dup", vector=v))
    eng.flush()                       # "dup" now stands in the delta
    (s, sl), vec = next(iter(eng._ivf_delta.items()))
    row = eng._ivf_layout.row_of(s, sl)
    assert eng._ivf.append_rows(np.array([row]), vec[None])  # on device too
    dists, keys = eng.search_batch(v[None], 5)
    assert keys[0].count("dup") == 1 and keys[0][0] == "dup"


@pytest.mark.parametrize("kw", [
    {"ivf_pq_subq": 8, "search_coalesce": True},
    {"ivf_pq_subq": 4, "ivf_opq": True, "mirror_backend": "mmap"}])
def test_ivf_waiting_configurations_raise(kw, tmp_path):
    """IVF-PQ and OPQ run (tests/test_torch_engine_ivf_pq.py); search
    coalescing runs beside them (a solo search is a group of one and
    answers as an uncoalesced engine does), and OPQ on mmap mirrors serves
    the keys of RAM mirrors. The same configuration runs on a 4-slot mesh
    (tests/test_torch_engine_mesh.py holds the mesh against the JAX
    engine)."""
    rng = np.random.default_rng(5)
    data = rng.standard_normal((300, DIM)).astype(np.float32)
    keys = [f"k{i}" for i in range(300)]
    if kw.get("search_coalesce"):
        runs = (("coalesced", kw),
                ("direct", dict(kw, search_coalesce=False)))
    else:
        runs = (("mmap", dict(kw, mirror_backend="mmap")),
                ("ram", dict(kw, mirror_backend="ram")))
    got = []
    for sub, cfg in runs:
        eng = engine(data_dir=str(tmp_path / sub), **cfg)
        assert eng.put_rows(keys, data).success
        got.append(eng.search_batch(data[:8], 10))
        info = eng.info()
        assert info["mirror_backend"] == cfg.get("mirror_backend", "ram")
        assert (info["search_groups"] == {1: 1}) == bool(
            cfg.get("search_coalesce"))
    assert got[0][1] == got[1][1]
    np.testing.assert_allclose(got[0][0], got[1][0], rtol=1e-5,
                               atol=1e-4)
    still = {k: v for k, v in kw.items() if k.startswith("ivf_")}
    assert engine(**still)._ivf is None  # constructs; no index before data
    eng = VectorDBEngine(ivf_config(**kw), data_dir=str(tmp_path / "mesh"),
                         device="cpu", mesh=create_mesh(devices=["cpu"] * 4))
    assert eng.put_rows(keys, data).success
    _, got_keys = eng.search_batch(data[:8], 10)
    assert type(eng._ivf).__name__ == "ShardedIVFIndex"
    assert [k[0] for k in got_keys] == keys[:8]
