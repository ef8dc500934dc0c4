"""The port's mmap mirrors (mirror_backend "mmap", and "auto" with a
data_dir) on the native runtime.

* An engine on the native doc store with mmap mirrors serves the keys and
  distances of the engine on the python doc store with RAM mirrors, fed
  the same rows, for flat f32 (f32 mirrors), flat int8 (int8 mirrors), IVF
  int8 and IVF-PQ (8-bit, 4-bit, OPQ), with distances at rtol 1e-5, atol
  1e-4. Against the JAX engine the parity rules of ROADMAP.md §3 hold: the
  flat engines return the same keys ("exact" search); the IVF engines,
  which take other candidate routes on the CPU in the JAX package, agree in
  the first key and each keeps recall@10 >= 0.9 against an exact scan.
* A checkpoint hardlinks the mirror files (same inode), a restart adopts
  the checkpoint's links and replays the WAL tail, and compaction unlinks
  the files it swapped out while an older checkpoint still restores.
* Both directions of restore: a port data_dir written with the native doc
  store and mmap mirrors opens in the JAX engine with
  docstore_backend="python" (its python docstore.kv reader) and mmap
  mirrors, and a JAX data_dir with mmap mirrors opens in the port, with
  equal search results and counts.

The JAX package's native library is switched off here (its mmap mirrors
take np.memmap, its doc store and WAL python), so no test depends on the
reference's own build.
"""

import os

import numpy as np
import pytest

import tpuvdb.native as jax_native
from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.kernels.distance import numpy_oracle

DIM = 16
CONFIGS = {
    "flat_f32": ({}, "auto"),
    "flat_int8": ({"storage_dtype": "int8", "mirror_dtype": "int8"}, "mmap"),
    "ivf_int8": ({"index_type": "ivf", "storage_dtype": "int8",
                  "mirror_dtype": "int8"}, "auto"),
    "pq8": ({"index_type": "ivf", "ivf_pq_subq": 4}, "mmap"),
    "pq4": ({"index_type": "ivf", "ivf_pq_subq": 4, "ivf_pq_bits": 4},
            "auto"),
    "opq": ({"index_type": "ivf", "ivf_pq_subq": 4, "ivf_opq": True},
            "mmap"),
}


@pytest.fixture(autouse=True)
def _no_reference_build(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)


def _cfg(cls, **kw):
    base = dict(vector_dim=DIM, shard_count=4, shard_capacity=4096,
                block_size=128, mirror_init_cap=256, search_mode="exact",
                ivf_nlist=8, ivf_nprobe=8, ivf_kmeans_iters=5,
                ivf_delta_max=64, checkpoint_every_puts=10 ** 9,
                compact_every_puts=10 ** 9)
    base.update(kw)
    return cls(**base)


def _port(path, **kw):
    kw.setdefault("docstore_backend", "native")
    kw.setdefault("mirror_backend", "mmap")
    return VectorDBEngine(_cfg(DBConfig, **kw), data_dir=str(path),
                          device="cpu")


def _jax(path, **kw):
    kw.setdefault("docstore_backend", "python")
    kw.setdefault("mirror_backend", "mmap")
    return JaxEngine(_cfg(JaxConfig, **kw), data_dir=str(path))


def _clustered(rng, n):
    centers = rng.standard_normal((16, DIM)).astype(np.float32) * 3
    return (centers[rng.integers(0, 16, n)]
            + rng.standard_normal((n, DIM)).astype(np.float32))


def _fill(eng, data):
    keys = [f"k{i}" for i in range(len(data))]
    assert eng.put_rows(keys, data).success
    for i in range(0, 60, 7):
        assert eng.delete(f"k{i}").success
    return keys


def _search(eng, queries):
    d, k = eng.search_batch(queries, 10)
    return np.asarray(d), k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mmap_native_engine_serves_the_ram_python_keys(tmp_path, name):
    kw, backend = CONFIGS[name]
    rng = np.random.default_rng(8)
    data = _clustered(rng, 1200)
    queries = data[60:76] + 0.05
    mm = _port(tmp_path / "mmap", mirror_backend=backend, **kw)
    ram = _port(tmp_path / "ram", docstore_backend="python",
                mirror_backend="ram", **kw)
    info = mm.info()
    assert (info["mirror_backend"], info["docstore_backend"],
            info["wal_backend"], info["rescore_backend"]) == (
        "mmap", "native", "native", "native")
    keys = _fill(mm, data)
    _fill(ram, data)
    (d, k), (d_ref, k_ref) = _search(mm, queries), _search(ram, queries)
    assert k == k_ref
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)
    assert os.listdir(tmp_path / "mmap" / "mirrors")

    jax = _jax(tmp_path / "jax", mirror_backend="ram", **kw)
    _fill(jax, data)
    d_j, k_j = _search(jax, queries)
    if kw.get("index_type") != "ivf":
        assert k == k_j
        np.testing.assert_allclose(d, d_j, rtol=1e-5, atol=1e-4)
        return
    live = np.ones(len(data), bool)
    live[0:60:7] = False
    _, truth = numpy_oracle(queries, data, live, 10)
    for got in (k, k_j):
        hits = [len(set(row) & {keys[i] for i in t}) for row, t in
                zip(got, truth)]
        assert sum(hits) / truth.size >= 0.9
    assert [row[0] for row in k] == [row[0] for row in k_j]


def _inode(p):
    return os.stat(p).st_ino


@pytest.mark.parametrize("mirror_dtype", ["float32", "int8"])
def test_checkpoint_hardlinks_and_restart_adopts(tmp_path, mirror_dtype):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((500, DIM)).astype(np.float32)
    kw = dict(mirror_dtype=mirror_dtype, storage_dtype=mirror_dtype)
    eng = _port(tmp_path, **kw)
    _fill(eng, data)
    ckpt = eng.save_checkpoint()
    for s, m in enumerate(eng.mirrors):
        for part, path in m.file_paths.items():
            assert _inode(path) == _inode(os.path.join(ckpt,
                                                       f"shard_{s}.{part}"))
    assert os.path.exists(os.path.join(ckpt, "docstore.kv"))
    # a WAL tail past the checkpoint, then a restart without close
    assert eng.put_rows(["tail0", "tail1"], data[:2] * 3).success
    assert eng.delete("k100").success
    want = _search(eng, data[200:208])
    restarted = _port(tmp_path, **kw)
    assert restarted.count() == eng.count()
    assert restarted.stats["wal_replayed"] == 3
    got = _search(restarted, data[200:208])
    assert got[1] == want[1] and not restarted.get("k100").success
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    for s, m in enumerate(restarted.mirrors):  # adopted: linked, not copied
        assert (_inode(m.file_paths["vec"])
                == _inode(os.path.join(ckpt, f"shard_{s}.vec")))
    names = set(os.listdir(tmp_path / "mirrors"))
    assert names == {os.path.basename(p) for m in restarted.mirrors
                     for p in m.file_paths.values()}  # orphans collected
    eng.wal.close()
    restarted.close()


def test_compaction_unlinks_the_swapped_out_files(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((400, DIM)).astype(np.float32)
    eng = _port(tmp_path, max_checkpoints=4)
    _fill(eng, data)
    ckpt = eng.save_checkpoint()
    old = [p for m in eng.mirrors for p in m.file_paths.values()]
    want = _search(eng, data[100:110])
    eng.compact()
    assert not any(os.path.exists(p) for p in old)
    new = {os.path.basename(p) for m in eng.mirrors
           for p in m.file_paths.values()}
    assert set(os.listdir(tmp_path / "mirrors")) == new
    assert sum(m.deleted for m in eng.mirrors) == 0
    got = _search(eng, data[100:110])
    assert got[1] == want[1]
    # the checkpoint before the compaction kept its own links
    assert os.path.getsize(os.path.join(ckpt, "shard_0.vec")) > 0
    eng.close()
    again = _port(tmp_path)
    assert again.count() == eng.count()
    assert _search(again, data[100:110])[1] == want[1]
    again.close()


@pytest.mark.parametrize("mirror_dtype", ["float32", "int8"])
def test_port_data_dir_restores_in_jax(tmp_path, mirror_dtype):
    rng = np.random.default_rng(6)
    data = rng.standard_normal((500, DIM)).astype(np.float32)
    kw = dict(mirror_dtype=mirror_dtype, storage_dtype=mirror_dtype)
    port = _port(tmp_path, **kw)
    _fill(port, data)
    port.save_checkpoint()
    assert port.put_rows(["tail"], data[:1] * 2).success  # WAL tail
    want = _search(port, data[300:310])
    port.wal.close()
    jax = _jax(tmp_path, **kw)
    assert jax.docstore.backend == "python"
    assert jax.count() == port.count()
    got = _search(jax, data[300:310])
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    assert jax.get("tail").success and not jax.get("k7").success


@pytest.mark.parametrize("mirror_dtype", ["float32", "int8"])
def test_jax_data_dir_restores_in_port(tmp_path, mirror_dtype):
    rng = np.random.default_rng(7)
    data = rng.standard_normal((500, DIM)).astype(np.float32)
    kw = dict(mirror_dtype=mirror_dtype, storage_dtype=mirror_dtype)
    jax = _jax(tmp_path, **kw)
    _fill(jax, data)
    ckpt = jax.save_checkpoint()
    assert jax.put_rows(["tail"], data[:1] * 2).success
    want = _search(jax, data[300:310])
    jax.wal.close()
    port = _port(tmp_path, **kw)
    assert port.count() == jax.count()
    got = _search(port, data[300:310])
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    assert port.get("tail").success and not port.get("k7").success
    assert (_inode(port.mirrors[0].file_paths["vec"])
            == _inode(os.path.join(ckpt, "shard_0.vec")))
    port.close()
