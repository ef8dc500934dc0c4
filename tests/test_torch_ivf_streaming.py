"""The port's durable IVF node under a stream of single-row writes (on the
CPU), held to a plain exact kNN over the rows live at each search.

* A durable IVF engine (the WAL, a checkpoint every 100 puts, mmap mirrors)
  on 2,000 seeded base rows, 32-d, 4 shards, 16 cells, all of them probed.
* 600 single-row writes, insert:delete 1:1. A delete takes a base key, or
  now and then a key the stream inserted. The inserts crowd two of the
  centres, and `ivf_delta_max` is 48, so the standing delta drains into
  the cells' free slots and, once the crowded cells are full, into the
  spill.
* Every 5 writes a b4 search, and every 10 a flush and then a b4 search:
  two queries by the centres, a self-query of the newest insert still in
  the host delta and one of an insert already drained into the index.
* `race`: a write lands inside some searches. "version": a delete flushed
  during the probe, so the search retries on IVFIndex.version. "generation":
  inserts flushed until the delta drains, after the probe and before the
  key resolution, so the search retries on the engine generation. The
  answer is held against the rows live when the search returned.
* Then a crash stop as perfbench/program.py `crash` makes it (no
  background flush, the WAL's file closed, no closing checkpoint), a
  reopen, the same comparison, and every written key read back bit for
  bit.
* The counters: `ivf_appends` and `ivf_spill_appends` grew,
  `search_delta_rows` is the sum of the snapshots the test counts (the
  inserted rows not yet drained, at each attempt), and the retries by
  cause sum to `search_retries`.

What the reference holds exactly: k distinct keys, each live, in
ascending order; each served distance the exact distance of its key's row
to rtol 1e-5, with a floor of 1e-6 for a self-query's 0 (the distances come
from the |q|^2 + |x|^2 - 2 q.x expansion); every host-delta row among the exact k best (within 1e-6) is
served, since the delta is scored exactly; every self-query serves its row
first. The probe keeps one candidate per (segment, column) slot, as the
reference's Pallas kernel does, so even with every cell probed two close
rows of one slot can crowd each other out: the rest is held to recall@10
over the run, at the configuration's `recall_target` (0.95). The
reference is plain torch in float64 (TF32 off), nothing of the port's
kernels and nothing of JAX.
"""

import numpy as np
import pytest
import torch

from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.core.errors import NOT_FOUND_PREFIX
from tpuvdb_torch.core.types import VectorData
from tpuvdb_torch.engine.engine import RETRY_CAUSES
from tpuvdb_torch.index.ivf import IVFIndex
from tpuvdb_torch.utils import tracing

DIM, BASE, CENTRES, WRITES, K, BATCH = 32, 2000, 16, 600, 10, 4


def _config():
    return DBConfig(
        vector_dim=DIM, shard_count=4, index_type="ivf", ivf_nlist=16,
        ivf_nprobe=16, ivf_kmeans_iters=5, ivf_train_sample=4096,
        ivf_delta_max=48, wal_enabled=True, wal_fsync=True,
        checkpoint_every_puts=100, compact_every_puts=10 ** 9,
        mirror_backend="auto", search_coalesce=True)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _exact_topk(queries, live):
    """The k nearest live rows of each query: plain torch, float64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    keys = list(live)
    mat = torch.from_numpy(np.stack([live[k] for k in keys])).double()
    q = torch.from_numpy(queries).double()
    d = ((q[:, None, :] - mat[None, :, :]) ** 2).sum(-1)
    top = torch.topk(d, K, dim=1, largest=False)
    return d.numpy(), keys, top.values.numpy()


def _check(queries, dists, served, live, delta, tally):
    """Each answer against the exact k best of `live` (key -> vector):
    the module docstring's exact properties, and the misses counted in
    `tally` for the run's recall."""
    d_all, keys, top_d = _exact_topk(queries, live)
    col = {k: i for i, k in enumerate(keys)}
    for i in range(len(queries)):
        got = served[i]
        assert len(got) == K and len(set(got)) == K, got
        assert all(k in col for k in got), got  # nothing deleted or unknown
        ref = np.array([d_all[i, col[k]] for k in got])
        # the expansion rounds at |q|^2 + |x|^2 = 2: a self-query's 0 comes
        # back as a few 1e-7 either way, whence the absolute floor
        np.testing.assert_allclose(np.asarray(dists[i], np.float64), ref,
                                   rtol=1e-5, atol=1e-6)
        assert np.all(np.diff(np.asarray(dists[i])) >= 0)
        kth = top_d[i][-1] + 1e-6
        owed = {k for k in delta if d_all[i, col[k]] <= kth}
        assert owed <= set(got), (owed - set(got))
        tally[0] += int(np.sum(ref <= kth))
        tally[1] += K


class _Stream:
    """The seeded writes, the rows live after each, and the test's own
    count of what a search scores on the host: the inserted rows that no
    drain or rebuild has moved into the index yet."""

    def __init__(self, eng, seed):
        self.eng = eng
        self.rng = np.random.default_rng(seed)
        cents = _unit(self.rng.standard_normal((CENTRES, DIM)) * 3.0)
        self.cents = cents
        base = _unit(cents[np.arange(BASE) % CENTRES]
                     + self.rng.standard_normal((BASE, DIM)) * 0.4)
        self.live = {f"r{i}": base[i] for i in range(BASE)}
        self.written = {}          # key -> its last vector, None: deleted
        self.undrained = set()     # inserted, live, not yet in the index
        self.untouched = set(self.live)
        self.fresh = 0
        self.expected_delta_rows = 0
        self.tally = [0, 0]        # hits of the exact k best, and k's
        assert eng.put_rows(list(self.live), base).success
        eng.flush()
        assert eng._ivf.nprobe == eng._ivf.nlist

    def _index_moves(self):
        stats = self.eng.stats
        return (stats.get("ivf_appends", 0),
                self.eng.timers.snapshot().get("index.build",
                                               {}).get("count", 0))

    def flush(self):
        before = self._index_moves()
        self.eng.flush()
        if self._index_moves() != before:
            self.undrained.clear()  # drained into the cells or rebuilt

    def insert(self):
        # two crowded centres: their cells fill and the spill takes the rest
        c = self.cents[self.rng.integers(0, 2)]
        v = _unit((c + self.rng.standard_normal(DIM) * 0.4)[None])[0]
        key = f"w{self.fresh}"
        self.fresh += 1
        assert self.eng.put(VectorData(
            key=key, vector=v, metadata={"file_path": f"images/{key}.jpg"}
        )).success
        self.live[key] = self.written[key] = v
        self.undrained.add(key)

    def delete(self):
        ours = [k for k in self.undrained if k in self.live]
        if ours and self.rng.random() < 0.3:
            key = sorted(ours)[self.rng.integers(0, len(ours))]
        else:
            key = sorted(self.untouched)[self.rng.integers(
                0, len(self.untouched))]
        assert self.eng.delete(key).success
        del self.live[key]
        self.written[key] = None
        self.untouched.discard(key)
        self.undrained.discard(key)

    def queries(self):
        """Two queries by a crowded and a random centre, and self-queries
        of the newest insert in the host delta and of a drained one."""
        near = self.cents[[self.rng.integers(0, 2),
                           self.rng.integers(0, CENTRES)]]
        q = _unit(near + self.rng.standard_normal((2, DIM)) * 0.4)
        fresh = sorted(self.undrained, key=lambda k: int(k[1:]))
        drained = sorted(k for k in self.written
                         if k in self.live and k not in self.undrained)
        own = [self.live[fresh[-1]]] if fresh else []
        if drained:
            own.append(self.live[drained[self.rng.integers(0,
                                                           len(drained))]])
        self.selves = range(2, 2 + len(own))
        return np.concatenate([q, *[v[None] for v in own],
                               q[:BATCH - 2 - len(own)]])

    def search(self, eng=None):
        eng = eng or self.eng
        q = self.queries()
        self.expected_delta_rows += len(self.undrained)  # the first attempt
        dists, keys = eng.search_batch(q, K)
        _check(q, dists, keys, self.live, self.undrained, self.tally)
        for i in self.selves:  # a self-query serves its row first
            key = keys[i][0]
            assert np.array_equal(self.live[key], q[i]), (i, keys[i])


def _races(stream, race, monkeypatch):
    """Arms `race` for the next search: the writes land inside it once,
    and the retried attempt counts the delta they leave."""
    armed = []

    def fire():
        if not armed:
            return
        armed.clear()
        if race == "version":
            stream.delete()
            stream.flush()
        else:
            drains = stream.eng.stats.get("ivf_appends", 0)
            while stream.eng.stats.get("ivf_appends", 0) == drains:
                stream.insert()
                stream.flush()
        stream.expected_delta_rows += len(stream.undrained)  # the retry

    if race == "version":
        real = IVFIndex.search

        def search(self, *a, **kw):
            out = real(self, *a, **kw)
            fire()
            return out
        monkeypatch.setattr(IVFIndex, "search", search)
    elif race == "generation":
        real = VectorDBEngine._assemble_results

        def assemble(self, *a, **kw):
            fire()
            return real(self, *a, **kw)
        monkeypatch.setattr(VectorDBEngine, "_assemble_results", assemble)
    return armed


def _read_back(eng, stream):
    for key, want in stream.written.items():
        r = eng.get(key)
        if want is None:
            assert not r.success and r.message.startswith(NOT_FOUND_PREFIX)
        else:
            got = np.asarray(r.vector_data.vector, np.float32)
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    for key in sorted(stream.untouched)[::20]:
        got = np.asarray(eng.get(key).vector_data.vector, np.float32)
        assert np.array_equal(got.view(np.uint32),
                              stream.live[key].view(np.uint32))


@pytest.mark.parametrize("race", [None, "version", "generation"])
def test_ivf_stream_matches_the_live_rows_through_drains_and_a_crash(
        tmp_path, monkeypatch, race):
    data_dir = str(tmp_path / "node")
    eng = VectorDBEngine(_config(), data_dir=data_dir, device="cpu")
    stream = _Stream(eng, seed=2 ** 31 + 21)
    armed = _races(stream, race, monkeypatch)
    ops = np.random.default_rng(7).permutation(
        np.repeat([0, 1], WRITES // 2).reshape(-1, 2), axis=1).reshape(-1)
    for i, op in enumerate(ops, 1):
        stream.insert() if op == 0 else stream.delete()
        if i % 10 == 0:
            stream.flush()
        if i % 5 == 0:
            if race is not None and i % 40 == 0:
                armed.append(True)
            stream.search()
    stats = dict(eng.stats)
    assert stats["ivf_appends"] > 0 and stats["ivf_spill_appends"] > 0
    assert stats["ivf_invalidated_rows"] > 0
    assert stats["ivf_delta_rows_max"] >= 48
    assert stats["search_delta_rows"] == stream.expected_delta_rows
    causes = {c: stats[f"search_retries_{c}"] for c in RETRY_CAUSES}
    assert sum(causes.values()) == stats["search_retries"]
    if race is None:
        assert stats["search_retries"] == 0
    else:
        assert causes[race] == WRITES // 40 == stats["search_retries"]
    assert stats["checkpoints"] > 0 and stats["wal_replayed"] == 0
    assert 1 - stream.tally[0] / stream.tally[1] <= 1 - _config().recall_target

    # the crash stop, then the reopen: the newest checkpoint and the WAL's
    # tail, the index rebuilt by assignment against its centroids
    monkeypatch.undo()
    eng.stop_background_flush()
    eng.wal.close()
    del eng
    reopened = VectorDBEngine(_config(), data_dir=data_dir, device="cpu")
    assert reopened.stats["wal_replayed"] > 0
    stream.eng = reopened
    stream.undrained = set()  # its first search's flush builds them all in
    for _ in range(8):
        stream.search()
    assert 1 - stream.tally[0] / stream.tally[1] <= 1 - _config().recall_target
    _read_back(reopened, stream)
    reopened.close()


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_read_only_searches_record_no_delta_merge(rng, index_type):
    """A search with no host delta opens no `index.delta_merge` span and
    counts no `search_delta_rows`: the read-only cells pay nothing for it,
    and their span trees are test_torch_tracing.py's."""
    eng = VectorDBEngine(DBConfig(
        vector_dim=16, shard_count=2, shard_capacity=8192,
        index_type=index_type, ivf_nlist=16, ivf_nprobe=4,
        ivf_kmeans_iters=3, wal_enabled=False,
        checkpoint_every_puts=10 ** 9, compact_every_puts=10 ** 9,
        search_coalesce=True), device="cpu")
    data = rng.standard_normal((4096, 16)).astype(np.float32)
    assert eng.put_rows([f"k{i}" for i in range(4096)], data).success
    eng.flush()
    q = rng.standard_normal((8, 16)).astype(np.float32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(10):
            eng.search_batch(q, 10)
    names = set(eng.info()["spans"]["names"])
    want = {"search.call", "search.snapshot", "search.device",
            "index.upload", "index.launch", "index.wait", "index.row_map",
            "search.assemble", "search.keys"}
    assert names == want | ({"index.plan"} if index_type == "ivf" else set())
    assert eng.stats["search_delta_rows"] == 0
    # one staged insert: the next traced search merges it, inside row_map
    assert eng.put(VectorData(key="new", vector=q[0])).success
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        dists, keys = eng.search_batch(q[:1], 10)
    spans = eng.info()["spans"]
    assert spans["names"]["index.delta_merge"]["count"] == 1
    assert keys[0][0] == "new" and eng.stats["search_delta_rows"] == 1
    assert tracing._tls.top is None
    eng.close()


def test_search_serializes_against_ivf_flushes(tmp_path, monkeypatch):
    """A flush that invalidates rows lands inside every probe of a search:
    its four lock-free attempts retry on the index version, and its
    serialized attempt, which holds the flush lock, keeps the next flush
    out of its probe (IVF's flush takes that lock, as the flat scatter
    does) and answers."""
    import threading

    eng = VectorDBEngine(_config(), data_dir=str(tmp_path / "node"),
                         device="cpu")
    stream = _Stream(eng, seed=5)
    real = IVFIndex.search
    flushes = []

    def search(self, *a, **kw):
        out = real(self, *a, **kw)
        stream.delete()  # one more row for the racing flush to clear
        t = threading.Thread(target=eng.flush)
        t.start()
        t.join(timeout=0.5)  # lands now, unless a serialized search waits
        flushes.append(t)
        return out
    monkeypatch.setattr(IVFIndex, "search", search)
    q = stream.queries()
    dists, keys = eng.search_batch(q, K)
    for t in flushes:
        t.join()
    monkeypatch.undo()
    assert len(flushes) == 5
    assert eng.stats["search_retries"] == eng.stats[
        "search_retries_version"] == 4
    assert all(len(ks) == K and len(set(ks)) == K for ks in keys)
    eng.close()
