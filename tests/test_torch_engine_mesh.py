"""tpuvdb_torch.VectorDBEngine on a mesh vs tpuvdb.VectorDBEngine on the
same mesh shape (on the CPU).

The scenarios of tests/test_engine_ivf_mesh.py, test_engine_replicated.py
and test_engine_ivf_replicated.py: the JAX engine on the conftest's
8-device CPU mesh, the port's on 8 CPU slots.
* Flat f32 on a (8,) and a (2, 4) mesh, "exact" mode: the same op
  sequence (puts, an overwrite, deletes, flushes) returns the same keys,
  distances within rtol 1e-5 (atol 1e-4 near 0); int8 with the per-slot
  "device" re-rank serves JAX's keys.
* IVF on a (8,) and a (2, 4) mesh: self-queries first in both, recall@5
  against the oracle, appends and deletes; the checkpointed per-shard
  centroid tables restart without k-means, in the port and from a JAX
  data_dir; an unsupported mesh raises.
* Filtered search on the mesh (the masks go to every slot) equals the
  single-device engine's; DBService takes the mesh.
"""

import numpy as np
import pytest
import torch

from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb.mesh.mesh import create_mesh as jax_create_mesh
from tpuvdb.mesh.replicated import create_mesh_2d as jax_mesh_2d
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.core.types import SearchRequest, VectorData
from tpuvdb_torch.kernels.distance import numpy_oracle
from tpuvdb_torch.mesh import Mesh, create_mesh
from tpuvdb_torch.mesh.replicated import create_mesh_2d
from tpuvdb_torch.mesh.sharded_ivf import ShardedIVFIndex

DIM = 16
CPU8 = ["cpu"] * 8


def _cfg(cls, **kw):
    base = dict(vector_dim=DIM, shard_count=4, shard_capacity=8192,
                block_size=128, checkpoint_every_puts=10**9,
                compact_every_puts=10**9)
    base.update(kw)
    return cls(**base)


def _ivf(cls, **kw):
    base = dict(index_type="ivf", ivf_nlist=32, ivf_nprobe=8,
                ivf_kmeans_iters=4, ivf_delta_max=64)
    base.update(kw)
    return _cfg(cls, **base)


def _meshes(shape):
    if shape == "2d":
        return create_mesh_2d(2, 4, devices=CPU8), jax_mesh_2d(2, 4)
    return create_mesh(devices=CPU8), jax_create_mesh()


def _rows(rng, n, prefix="k"):
    return {f"{prefix}{i}": rng.standard_normal(DIM).astype(np.float32)
            for i in range(n)}


def _put(engines, vecs):
    for eng in engines:
        assert eng.put_batch([VectorData(key=k, vector=v)
                              for k, v in vecs.items()]).success


def _same(engines, q, k):
    (d_t, k_t), (d_j, k_j) = (eng.search_batch(q, k) for eng in engines)
    assert k_t == k_j
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-4)
    return k_t


@pytest.mark.parametrize("shape", ["1d", "2d"])
def test_flat_engine_on_mesh_matches_jax(rng, shape):
    mesh, jmesh = _meshes(shape)
    engines = (VectorDBEngine(_cfg(DBConfig, search_mode="exact"),
                              mesh=mesh, device="cpu"),
               JaxEngine(_cfg(JaxConfig, search_mode="exact"), mesh=jmesh))
    vecs = _rows(rng, 300)
    _put(engines, vecs)
    q = rng.standard_normal((7, DIM)).astype(np.float32)  # odd: padded on 2-D
    _same(engines, q, 10)
    keys = _same(engines, np.stack([vecs[f"k{i}"] for i in range(20, 26)]), 1)
    assert [k[0] for k in keys] == [f"k{i}" for i in range(20, 26)]
    # an overwrite, deletes, a flush: staged and flushed states agree
    new = {"k7": vecs["k8"] + 0.001, "fresh": vecs["k9"] - 0.001}
    _put(engines, new)
    for eng in engines:
        assert eng.delete("k9").success and eng.delete("k100").success
    _same(engines, np.stack([vecs["k8"], vecs["k9"], vecs["k100"]]), 5)
    for eng in engines:
        eng.flush()
    keys = _same(engines, np.stack([vecs["k8"], vecs["k9"], vecs["k100"]]), 5)
    assert "k9" not in keys[1] and "k100" not in keys[2]
    assert type(engines[0]._index.vectors) is list
    # the port counts every replica's copy, the reference's global array
    # one copy
    copies = 2 if shape == "2d" else 1
    assert engines[0].info()["device_bytes"] == copies * engines[1].info()[
        "device_bytes"]


def test_int8_device_rescore_on_replicated_mesh(rng):
    """rescore_mode="device" on a 2-D mesh: each slot re-ranks its own
    candidates before the merge; the scores are exact over the stored
    rows, the keys JAX's."""
    mesh, jmesh = _meshes("2d")
    kw = dict(storage_dtype="int8", rescore_mode="device",
              rescore_overfetch=8)
    engines = (VectorDBEngine(_cfg(DBConfig, **kw), mesh=mesh, device="cpu"),
               JaxEngine(_cfg(JaxConfig, **kw), mesh=jmesh))
    vecs = _rows(rng, 200)
    _put(engines, vecs)
    q = np.stack([vecs[f"k{i}"] for i in range(30, 36)])
    keys = _same(engines, q, 3)
    assert engines[0]._index.rescore_fetch > 0
    assert [k[0] for k in keys] == [f"k{i}" for i in range(30, 36)]
    d, _ = engines[0].search_batch(q, 1)
    assert (d[:, 0] < 0.05).all()


@pytest.mark.parametrize("shape", ["1d", "2d"])
def test_ivf_engine_on_mesh(rng, shape):
    mesh, jmesh = _meshes(shape)
    eng = VectorDBEngine(_ivf(DBConfig), mesh=mesh, device="cpu")
    jeng = JaxEngine(_ivf(JaxConfig), mesh=jmesh)
    vecs = _rows(rng, 600)
    _put((eng, jeng), vecs)
    for e in (eng, jeng):
        e.flush()
    assert isinstance(eng._ivf, ShardedIVFIndex)
    assert eng._ivf.repl_axis == ("repl" if shape == "2d" else None)
    # self-queries first in both (an odd batch pads over the replicas)
    keys = [f"k{i}" for i in range(41, 54)]
    q = np.stack([vecs[k] for k in keys])
    for e in (eng, jeng):
        _, got = e.search_batch(q, 1)
        assert [g[0] for g in got] == keys
    # recall@5 against brute force, for both
    corpus_keys = sorted(vecs)
    mat = np.stack([vecs[k] for k in corpus_keys])
    qs = rng.standard_normal((16, DIM)).astype(np.float32)
    d2 = ((qs[:, None, :] - mat[None]) ** 2).sum(-1)
    want = [{corpus_keys[j] for j in row} for row in np.argsort(d2, 1)[:, :5]]
    for e in (eng, jeng):
        _, got = e.search_batch(qs, 5)
        hits = sum(len(w & set(g)) for w, g in zip(want, got))
        assert hits / 80 >= 0.7
    # delta overflow drains by append; deletes propagate to every replica
    for wave in range(2):
        more = _rows(rng, 100, prefix=f"w{wave}_")
        vecs.update(more)
        _put((eng,), more)
        eng.flush()
    assert eng.stats.get("ivf_appends", 0) > 0
    for key in ("k42", "w0_5", "w1_99"):
        r = eng.search(SearchRequest(query_vector=vecs[key], top_k=3))
        assert r.success and r.search_result.keys[0] == key, key
        assert r.search_result.scores[0] < 1e-2
    assert eng.delete("w0_5").success
    eng.flush()
    r = eng.search(SearchRequest(query_vector=vecs["w0_5"], top_k=3))
    assert "w0_5" not in r.search_result.keys
    assert eng.info()["ivf"]["nlist"] > 0


def _no_training(monkeypatch):
    import tpuvdb_torch.mesh.sharded_ivf as mod

    def fail(*a, **k):
        raise AssertionError("per-shard k-means ran on a warm restart")

    monkeypatch.setattr(mod, "kmeans", fail)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mesh_ivf_warm_restart_skips_training(rng, tmp_path, monkeypatch,
                                              writer):
    """The checkpointed (shards, nlist, d) centroid tables skip every
    per-shard k-means on restart, from the port's data_dir and from a JAX
    one."""
    d = str(tmp_path / "db")
    kw = dict(ivf_delta_max=10_000)
    if writer == "port":
        eng = VectorDBEngine(_ivf(DBConfig, **kw), data_dir=d,
                             mesh=create_mesh(devices=CPU8), device="cpu")
    else:
        eng = JaxEngine(_ivf(JaxConfig, **kw), data_dir=d,
                        mesh=jax_create_mesh())
    vecs = _rows(rng, 600)
    _put((eng,), vecs)
    eng.flush()
    eng.close()
    _no_training(monkeypatch)
    eng2 = VectorDBEngine(_ivf(DBConfig, **kw), data_dir=d,
                          mesh=create_mesh(devices=CPU8), device="cpu")
    try:
        r = eng2.search(SearchRequest(query_vector=vecs["k123"], top_k=3))
        assert r.success and r.search_result.keys[0] == "k123"
        assert r.search_result.scores[0] < 1e-2
        assert eng2._ivf.centroids_np().ndim == 3
    finally:
        eng2.close()
    # another shard count retrains (the table no longer fits)
    with pytest.raises(AssertionError, match="k-means ran"):
        VectorDBEngine(_ivf(DBConfig, **kw), data_dir=d,
                       mesh=create_mesh(devices=["cpu"] * 4),
                       device="cpu").search_batch(vecs["k1"][None], 1)


def test_engine_ivf_unsupported_mesh_raises(rng):
    devs = np.empty(8, object)
    devs[:] = [torch.device("cpu")] * 8
    mesh = Mesh(devs.reshape(2, 2, 2), ("a", "b", "shards"))
    eng = VectorDBEngine(_ivf(DBConfig), mesh=mesh, device="cpu")
    _put((eng,), _rows(rng, 200))
    with pytest.raises(ValueError, match="IVF needs"):
        eng.flush()


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_filtered_search_on_mesh(rng, index_type):
    """The device filter path on a mesh: the candidate mask reaches every
    slot, and the hits are the single-device engine's."""
    kw = dict(search_mode="exact")
    if index_type == "ivf":
        kw = dict(index_type="ivf", ivf_nlist=8, ivf_nprobe=8,
                  ivf_kmeans_iters=4, ivf_delta_max=64)
    got = []
    for mesh in (None, create_mesh(devices=["cpu"] * 4)):
        eng = VectorDBEngine(_cfg(DBConfig, **kw), mesh=mesh, device="cpu")
        eng._FILTER_DEVICE_MIN = 50
        data = np.random.default_rng(6).standard_normal(
            (400, DIM)).astype(np.float32)
        assert eng.put_batch([
            VectorData(key=f"k{i}", vector=data[i],
                       metadata={"g": str(i % 3)})
            for i in range(400)]).success
        eng.flush()
        hits = eng.search_hits(data[5], 8, filter_metadata={"g": "2"})
        got.append([(h.key, round(h.score, 4)) for h in hits])
    assert got[0] == got[1] and len(got[0]) == 8
    assert all(int(k[1:]) % 3 == 2 for k, _ in got[0])


def test_service_on_mesh(rng):
    from tpuvdb_torch.api.service import DBService

    mesh = create_mesh(devices=CPU8)
    svc = DBService(_cfg(DBConfig), mesh=mesh, device="cpu")
    try:
        v = rng.standard_normal(DIM).astype(np.float32)
        assert svc.rpc_put({"key": "a", "vector": v.tolist()})["success"]
        r = svc.rpc_search({"query_vector": v.tolist(), "top_k": 1})
        assert r["success"] and r["search_result"]["keys"] == ["a"]
        assert len(svc.registry.list_nodes()) == mesh.size
    finally:
        svc.close()


@pytest.mark.parametrize("k", [10, 16])
def test_mesh_ivf_pq_cold_recall_agrees_with_jax(k):
    """Both packages' mesh IVF-PQ engines train cold on one clustered
    corpus (the card phase's shape: centres 3 apart at spread 0.4, the
    clusters far larger than the window), the port on 4 CPU slots, the
    reference on 4 virtual CPU devices: recall@10 at the default 64 x k
    window within 0.02 of each other, at the default k = 10 and at k =
    16. Both mesh engines round the device fetch up to a power of two and
    rank the whole of it (1,024 candidates at either k); when the port
    ranked 640 at k = 10 its recall here was 0.8516 against the
    reference's 0.925."""
    rng = np.random.default_rng(0)
    n, d = 32768, 64
    cents = 3 * rng.standard_normal((8, d)).astype(np.float32)
    data = (cents[rng.integers(0, 8, n)]
            + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    q = (cents[rng.integers(0, 8, 64)]
         + 0.4 * rng.standard_normal((64, d))).astype(np.float32)
    _, truth = numpy_oracle(q, data, np.ones(n, bool), 10)
    keys = [f"k{i}" for i in range(n)]
    kw = dict(vector_dim=d, shard_capacity=n, ivf_nlist=64, ivf_nprobe=8,
              ivf_kmeans_iters=5, ivf_pq_subq=4)
    recall = {}
    for name, eng in (
            ("port", VectorDBEngine(_ivf(DBConfig, **kw),
                                    mesh=create_mesh(devices=["cpu"] * 4),
                                    device="cpu")),
            ("jax", JaxEngine(_ivf(JaxConfig, **kw),
                              mesh=jax_create_mesh(4)))):
        assert eng.config.ivf_pq_rescore_overfetch == 64
        assert eng.put_rows(keys, data).success
        eng.flush()
        _, got = eng.search_batch(q, k)
        recall[name] = np.mean([len({keys[j] for j in t} & set(g[:10])) / 10
                                for t, g in zip(truth, got)])
    assert recall["port"] < 1.0  # the window binds on this corpus
    assert abs(recall["port"] - recall["jax"]) <= 0.02, recall
