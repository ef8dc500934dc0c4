"""The port's DocStore on the native C++ KV against the python dict.

Mirrors tests/test_native_docstore.py, tests/test_docstore_scale.py (at a
size for the CPU run: 200,000 keys, no timing bounds) and
tests/test_property_docstore.py (hypothesis: both backends in lockstep):
* python / native parity of put, overwrite, delete, reverse lookup and the
  metadata index; dump / load and the native docstore.kv snapshot across
  backends and packages;
* `keys_rows` (liveness and keys in one crossing) against per-row lookups;
* the `put_rows_bulk` fast path and the engine's columnar ingest on it;
* an engine on the native doc store returns the keys and distances of the
  engine on the python doc store and of the JAX engine (search_mode
  "exact", distances at rtol 1e-5, atol 1e-4), through a checkpoint, a
  restart and a compaction.
"""

import numpy as np
import pytest
from hypothesis import settings
from hypothesis import strategies as st
from hypothesis.stateful import RuleBasedStateMachine, invariant, rule

from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb.store.kv import DocStore as JaxDocStore
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.core.types import VectorData
from tpuvdb_torch.store.kv import DocEntry, DocStore

DIM = 16


def test_native_docstore_parity():
    py = DocStore(backend="python")
    nat = DocStore(backend="native")
    assert (py.backend, nat.backend) == ("python", "native")
    for store in (py, nat):
        store.put(DocEntry("a", 1, 5, {"x": "1"}, 100))
        store.put(DocEntry("b", 0, 2, {"x": "2"}, 200))
        store.put(DocEntry("a", 1, 6, {"x": "3"}, 300))  # overwrite
    for store in (py, nat):
        assert len(store) == 2
        e = store.get("a")
        assert (e.shard, e.slot, e.metadata, e.timestamp) == (1, 6, {"x": "3"}, 300)
        assert store.key_at(1, 6) == "a"
        assert store.key_at(1, 5) is None  # the overwrite unmapped it
        assert store.find_by_metadata({"x": "3"}) == {(1, 6)}
        assert store.find_by_metadata({"x": "1"}) == set()
        assert store.keys_at_bulk([1, 0, 9], [6, 2, 0]) == ["a", "b", None]
        assert store.slots_live([1, 1, 0], [6, 5, 2]).tolist() == [True, False, True]
        assert store.delete("b").slot == 2
        assert store.get("b") is None and "b" not in store
        assert sorted(store.keys()) == ["a"]


def test_native_docstore_dump_load(tmp_path):
    nat = DocStore(backend="native")
    for i in range(500):
        nat.put(DocEntry(f"k{i}", i % 4, i, {"i": str(i)}, i * 10))
    p = str(tmp_path / "docs.msgpack")
    nat.dump(p)
    kv = str(tmp_path / "docstore.kv")
    nat.dump_native(kv)
    buf = nat.snapshot_native_mem()
    assert bytes(buf.view()) == open(kv, "rb").read()
    buf.release()
    stores = [DocStore.load(p, backend="python"),
              DocStore.load(p, backend="native"),
              DocStore.load_native_file(kv, backend="python"),
              DocStore.load_native_file(kv, backend="native"),
              JaxDocStore.load_native_file(kv, backend="python")]
    for store in stores:
        assert len(store) == 500
        assert store.get("k123").metadata == {"i": "123"}
        assert store.key_at(123 % 4, 123) == "k123"
        assert store.find_by_metadata({"i": "7"}) == {(3, 7)}
    with pytest.raises(RuntimeError, match="native backend"):
        stores[0].dump_native(kv)


def test_columnar_snapshot_and_remapped_reload():
    """export_snapshot / snapshot_columns / load_packed_remapped, the
    compaction path, on both backends."""
    for backend in ("python", "native"):
        store = DocStore(backend=backend)
        for i in range(40):
            store.put(DocEntry(f"k{i}", i % 2, i, {"m": "x"} if i % 5 == 0
                               else {}, i))
        snap = store.export_snapshot()
        keys, shards, slots, tss, mds = DocStore.snapshot_columns(snap)
        assert sorted(keys) == sorted(f"k{i}" for i in range(40))
        by_key = dict(zip(keys, zip(shards.tolist(), slots.tolist(),
                                    tss.tolist(), mds)))
        assert by_key["k10"] == (0, 10, 10, {"m": "x"})
        sh, sl = DocStore.snapshot_shard_slots(snap)
        assert sh.tolist() == shards.tolist() and sl.tolist() == slots.tolist()
        fresh = DocStore(backend=backend)
        assert fresh.load_packed_remapped(snap, slots + 100) == (
            backend == "native")
        if backend == "native":
            assert fresh.get("k10").slot == 110
            assert fresh.find_by_metadata({"m": "x"}) == {
                (i % 2, i + 100) for i in range(0, 40, 5)}


@pytest.mark.parametrize("backend", ["python", "native"])
def test_keys_rows_fused_resolution(backend):
    store = DocStore(backend=backend)
    phys_cap = 64
    for i in range(50):
        store.put(DocEntry(f"k{i}", i % 4, i // 4, {}, i))
    store.delete("k7")
    rows = [0, 1 * phys_cap, 3 * phys_cap + 2,  # live
            -1,                                 # device pad
            1 * phys_cap + 63,                  # in-range dead slot
            9 * phys_cap + 2]                   # shard out of range
    keys, miss = store.keys_rows(rows, phys_cap)
    want = [None if r < 0 else store.key_at(r // phys_cap, r % phys_cap)
            for r in rows]
    assert keys == want
    assert miss == sum(w is None for w in want) == 3
    keys, miss = store.keys_rows(rows, phys_cap, row=3)  # per-query lists
    assert keys == [want[:3], want[3:]] and miss == 3
    live = [(i % 4) * phys_cap + i // 4 for i in range(50) if i != 7]
    keys2, miss2 = store.keys_rows(live, phys_cap)
    assert miss2 == 0 and keys2 == [f"k{i}" for i in range(50) if i != 7]
    _, miss3 = store.keys_rows([(7 % 4) * phys_cap + 7 // 4], phys_cap)
    assert miss3 == 1  # the deleted key's slot


def test_put_rows_bulk_fast_path_semantics():
    store = DocStore(backend="native")
    prev_sh, prev_sl = store.put_rows_bulk([f"k{i}" for i in range(10)], 2,
                                           100)
    assert (prev_sh == -1).all()
    e = store.get("k3")
    assert (e.shard, e.slot, e.metadata) == (2, 103, {})
    assert store.key_at(2, 103) == "k3"
    prev_sh, prev_sl = store.put_rows_bulk(["k3", "k99"], 1, 0)
    assert prev_sh.tolist() == [2, -1] and prev_sl.tolist() == [103, -1]
    assert store.get("k3").shard == 1
    # an entry with metadata disables the fast path, as does python
    store.put(DocEntry("meta", 0, 7, {"a": "b"}, 0))
    assert store.put_rows_bulk(["x"], 0, 8) is None
    assert DocStore(backend="python").put_rows_bulk(["x"], 0, 0) is None


def test_engine_fast_ingest_matches_generic():
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((64, DIM)).astype(np.float32)
    keys = [f"k{i}" for i in range(64)]
    engines = []
    for backend in ("native", "python"):  # python = the generic loop
        eng = VectorDBEngine(DBConfig(
            vector_dim=DIM, shard_count=4, shard_capacity=4096,
            wal_enabled=False, docstore_backend=backend,
            checkpoint_every_puts=10 ** 9, compact_every_puts=10 ** 9),
            device="cpu")
        eng.put_rows(keys, vecs)
        eng.put_rows(keys[:10], vecs[:10])  # overwrites
        engines.append(eng)
    a, b = engines
    assert len(a.docstore) == len(b.docstore) == 64
    assert sorted(a._staged_deletes) == sorted(b._staged_deletes)
    assert a._staged_updates == b._staged_updates
    for k in keys:
        ea, eb = a.docstore.get(k), b.docstore.get(k)
        assert (ea.shard, ea.slot, ea.metadata) == (eb.shard, eb.slot,
                                                    eb.metadata)


def _cfg(cls, **kw):
    base = dict(vector_dim=DIM, shard_count=4, shard_capacity=4096,
                block_size=128, mirror_init_cap=256, search_mode="exact",
                checkpoint_every_puts=10 ** 9, compact_every_puts=10 ** 9)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("storage_dtype", ["float32", "int8"])
def test_engine_keys_native_equal_python_and_jax(tmp_path, storage_dtype):
    rng = np.random.default_rng(4)
    data = rng.standard_normal((400, DIM)).astype(np.float32)
    kw = dict(storage_dtype=storage_dtype)
    jax = JaxEngine(_cfg(JaxConfig, docstore_backend="python", **kw),
                    data_dir=str(tmp_path / "jax"))
    nat = VectorDBEngine(_cfg(DBConfig, docstore_backend="native", **kw),
                         data_dir=str(tmp_path / "nat"), device="cpu")
    py = VectorDBEngine(_cfg(DBConfig, docstore_backend="python", **kw),
                        data_dir=str(tmp_path / "py"), device="cpu")
    engines = (jax, nat, py)
    for eng in engines:
        assert eng.put_batch([VectorData(key=f"k{i}", vector=data[i],
                                         metadata={"p": str(i % 3)})
                              for i in range(300)]).success
        assert eng.put_rows([f"k{i}" for i in range(250, 400)],
                            data[250:]).success  # overwrites and new keys
        for i in range(0, 40, 3):
            eng.delete(f"k{i}")
    queries = data[:12] + 0.01

    def check(filters=None):
        got = [e.search_batch(queries, 10) for e in engines]
        for d, k in got[1:]:
            assert k == got[0][1]
            np.testing.assert_allclose(d, got[0][0], rtol=1e-5, atol=1e-4)
        hits = [e.search_hits(queries[3], 5, filter_metadata={"p": "1"})
                for e in engines]
        assert [h.key for h in hits[1]] == [h.key for h in hits[0]] == [
            h.key for h in hits[2]]

    check()
    nat.save_checkpoint()
    nat.put_rows(["tail"], data[:1] * 2)  # a WAL tail past the checkpoint
    nat.wal.close()
    nat = VectorDBEngine(_cfg(DBConfig, docstore_backend="native", **kw),
                         data_dir=str(tmp_path / "nat"), device="cpu")
    assert nat.docstore.backend == "native" and nat.count() == 387
    nat.delete("tail")
    engines = (jax, nat, py)
    check()
    for eng in engines:
        eng.compact()
    check()
    assert nat.info()["stats"]["compactions"] == 1


def test_native_docstore_at_scale(tmp_path):
    n, batch = 200_000, 50_000
    store = DocStore(backend="native")
    for lo in range(0, n, batch):
        store.put_many([DocEntry(key=f"key:{i:09d}", shard=i % 8,
                                 slot=i // 8, metadata={}, timestamp=i)
                        for i in range(lo, lo + batch)])
    assert len(store) == n
    for i in range(0, n, n // 100):
        assert store.get(f"key:{i:09d}").slot == i // 8
        assert store.key_at(i % 8, i // 8) == f"key:{i:09d}"
    p = str(tmp_path / "big.kv")
    store.dump_native(p)
    for backend in ("native", "python"):
        back = DocStore.load_native_file(p, backend=backend)
        assert len(back) == n
        assert back.key_at(3, 1000) == f"key:{1000 * 8 + 3:09d}"


KEYS = [f"k{i}" for i in range(8)]
TAGS = ["x", "y", "z"]


class DocStores(RuleBasedStateMachine):
    """The same ops on both backends; the observable state stays equal."""

    def __init__(self):
        super().__init__()
        self.py = DocStore(backend="python")
        self.nat = DocStore(backend="native")
        self.slot = 0

    @rule(key=st.sampled_from(KEYS), shard=st.integers(0, 3),
          tag=st.sampled_from(TAGS))
    def put(self, key, shard, tag):
        self.slot += 1
        e = DocEntry(key=key, shard=shard, slot=self.slot,
                     metadata={"t": tag}, timestamp=self.slot * 10)
        p1 = self.py.put(e)
        p2 = self.nat.put(DocEntry(**e.__dict__))
        assert (p1 is None) == (p2 is None)
        if p1 is not None:
            assert (p1.shard, p1.slot, p1.metadata) == \
                (p2.shard, p2.slot, p2.metadata)

    @rule(keys=st.lists(st.sampled_from(KEYS), min_size=1, max_size=4,
                        unique=True), shard=st.integers(0, 3))
    def put_many(self, keys, shard):
        entries = []
        for key in keys:
            self.slot += 1
            entries.append(DocEntry(key=key, shard=shard, slot=self.slot,
                                    metadata={}, timestamp=self.slot))
        assert self.py.put_many(entries) == self.nat.put_many(
            [DocEntry(**e.__dict__) for e in entries])

    @rule(key=st.sampled_from(KEYS))
    def delete(self, key):
        d1 = self.py.delete(key)
        d2 = self.nat.delete(key)
        assert (d1 is None) == (d2 is None)

    @invariant()
    def same_state(self):
        assert len(self.py) == len(self.nat)
        assert sorted(self.py.keys()) == sorted(self.nat.keys())
        for key in KEYS:
            a, b = self.py.get(key), self.nat.get(key)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.shard, a.slot, a.metadata, a.timestamp) == \
                    (b.shard, b.slot, b.metadata, b.timestamp)
                assert self.py.key_at(a.shard, a.slot) == key
                assert self.nat.key_at(a.shard, a.slot) == key
        for tag in TAGS:
            assert self.py.find_by_metadata({"t": tag}) == \
                self.nat.find_by_metadata({"t": tag})
        rows = list(range(-1, 4 * 64, 7))
        assert self.py.keys_rows(rows, 64) == self.nat.keys_rows(rows, 64)


DocStores.TestCase.settings = settings(
    max_examples=40, stateful_step_count=40, deadline=None)

TestDocStores = DocStores.TestCase
