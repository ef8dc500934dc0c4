"""tpuvdb_torch.index.exact.DeviceExactIndex vs the JAX DeviceExactIndex,
and the port's snapshot rule under concurrent scatters.

Arrays must be equal after build and after each scatter (sqnorms to rtol
1e-6: both sum the same f32 squares, in another order); exact-mode search
returns the same rows with distances within rtol 1e-5, plus atol 1e-4 for
distances near 0, where |q|^2 - (2 q.x - |x|^2) cancels to a few f32 ulps
of |q|^2.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvdb.index.exact import DeviceExactIndex as JaxIndex
from tpuvdb.index.layout import ShardMirror as JaxMirror
from tpuvdb.kernels.pallas_scan import pallas_l2sq_topk
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.index.exact import DeviceExactIndex
from tpuvdb_torch.index.layout import ShardMirror, StackedLayout

DIM, SHARDS, BLOCK = 24, 3, 256


def _mirrors(data, cls, counts, dels):
    out = []
    for s, n in enumerate(counts):
        m = cls(DIM, 4096, init_cap=256, block=128)
        m.write_batch(m.alloc(n), data[s][:n])
        for sl in dels[s]:
            m.mark_deleted(sl)
        out.append(m)
    return out


@pytest.fixture()
def shards(rng):
    counts = [300, 120, 513]
    data = [rng.standard_normal((n, DIM)).astype(np.float32) for n in counts]
    dels = [[0, 7, 299], [], [5, 512]]
    return counts, data, dels


def _assert_same_arrays(idx, jidx):
    np.testing.assert_array_equal(idx.vectors.float().numpy(),
                                  np.asarray(jidx.vectors, np.float32))
    np.testing.assert_allclose(idx.sqnorms.numpy(), np.asarray(jidx.sqnorms),
                               rtol=1e-6)
    np.testing.assert_array_equal(idx.valid.numpy(), np.asarray(jidx.valid))


def test_build_matches_jax(shards):
    counts, data, dels = shards
    idx = DeviceExactIndex.build(_mirrors(data, ShardMirror, counts, dels),
                                 block_size=BLOCK, search_mode="exact",
                                 device="cpu")
    jidx = JaxIndex.build(_mirrors(data, JaxMirror, counts, dels),
                          block_size=BLOCK, search_mode="exact")
    assert (idx.layout.phys_cap, idx.layout.total_rows) == (
        jidx.layout.phys_cap, jidx.layout.total_rows)
    _assert_same_arrays(idx, jidx)
    assert idx.nbytes() == jidx.nbytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_updates_deletes_and_search_match_jax(rng, shards, dtype):
    counts, data, dels = shards
    jidx = JaxIndex.build(_mirrors(data, JaxMirror, counts, dels),
                          dtype=getattr(jnp, dtype), block_size=BLOCK,
                          search_mode="exact")
    lay = StackedLayout(jidx.layout.num_shards, jidx.layout.phys_cap,
                        jidx.layout.dim)
    idx = DeviceExactIndex.from_numpy(
        lay, np.asarray(jidx.vectors, np.float32), np.asarray(jidx.sqnorms),
        np.asarray(jidx.valid), dtype=getattr(torch, dtype),
        block_size=BLOCK, search_mode="exact", device="cpu")
    _assert_same_arrays(idx, jidx)

    # new rows at fresh slots, plus pad rows (== total_rows) that both drop
    total = lay.total_rows
    rows = np.array([lay.row_of(0, 300), lay.row_of(1, 120),
                     lay.row_of(1, 121), total, total], np.int32)
    vecs = rng.standard_normal((5, DIM)).astype(np.float32)
    ok = np.array([True, True, False, True, True])
    idx.apply_updates(rows, vecs, ok)
    jidx.apply_updates(rows, vecs, ok)
    del_rows = np.array([lay.row_of(2, 10), lay.row_of(0, 300), total],
                        np.int32)
    idx.apply_deletes(del_rows)
    jidx.apply_deletes(del_rows)
    _assert_same_arrays(idx, jidx)
    assert idx.version == 2

    q = rng.standard_normal((7, DIM)).astype(np.float32)
    q[0] = vecs[1]  # the freshly written row is its own nearest neighbour
    dist, got = idx.search(q, 10)
    jdist, jgot = jidx.search(q, 10)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_allclose(dist, jdist, rtol=1e-5, atol=1e-4)
    assert got[0, 0] == lay.row_of(1, 120)


def test_pallas_mode_search_matches_pallas_interpret(rng, shards):
    counts, data, dels = shards
    jidx = JaxIndex.build(_mirrors(data, JaxMirror, counts, dels),
                          block_size=BLOCK)
    idx = DeviceExactIndex.build(_mirrors(data, ShardMirror, counts, dels),
                                 block_size=BLOCK, search_mode="pallas",
                                 device="cpu")
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    dist, got = idx.search(q, 10)
    jdist, jgot = pallas_l2sq_topk(
        jnp.asarray(q), jidx.vectors, jidx.sqnorms, jidx.valid, k=10,
        block_rows=512, n_buckets=512, query_tile=8, sub_rows=512,
        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(jgot))
    np.testing.assert_allclose(dist, np.asarray(jdist), rtol=1e-5)


def test_int8_storage_waits_for_its_slice():
    """It waited for the int8 slice and no longer does: the index holds
    int8 rows with unit scales until rows arrive (parity with the reference
    is in test_torch_quant.py). A dtype outside the storage types raises."""
    idx = DeviceExactIndex(StackedLayout(1, 128, 8), dtype=torch.int8,
                           device="cpu")
    assert idx.quantized and idx.vectors.dtype == torch.int8
    assert (idx.row_scales == 1.0).all() and not idx.valid.any()
    assert idx.nbytes() == 128 * (8 + 4 + 4 + 1)
    with pytest.raises(ValueError, match="storage dtype"):
        DeviceExactIndex(StackedLayout(1, 128, 8), dtype=torch.float16,
                         device="cpu")


# ----------------------------------------------------------- snapshot rule


def _engine(rng, n=400):
    cfg = DBConfig(vector_dim=DIM, shard_count=2, mirror_init_cap=256,
                   block_size=BLOCK, search_mode="exact")
    eng = VectorDBEngine(cfg, device="cpu")
    data = rng.standard_normal((n, DIM)).astype(np.float32)
    eng.put_rows([f"k{i}" for i in range(n)], data)
    eng.flush()
    return eng, data


def _no_duplicates(keys):
    for row in keys:
        live = [k for k in row if k is not None]
        assert len(live) == len(set(live)), row


def test_scatter_racing_a_search_retries_without_duplicates(rng):
    """A flush lands while the scan runs: the scan sees the new rows and
    the host delta still holds them. The version check retries."""
    eng, _ = _engine(rng)
    fresh = rng.standard_normal((20, DIM)).astype(np.float32)
    eng.put_rows([f"new{i}" for i in range(20)], fresh)  # staged, < flush_batch
    index = eng._index
    real_search = index.search
    raced = []

    def search_with_racing_flush(queries, k, valid=None):
        if not raced:
            t = threading.Thread(target=eng.flush)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            raced.append(True)
        return real_search(queries, k, valid)

    index.search = search_with_racing_flush
    dists, keys = eng.search_batch(fresh, 10)
    assert raced and eng.stats["search_retries"] >= 1
    _no_duplicates(keys)
    assert [row[0] for row in keys] == [f"new{i}" for i in range(20)]


def test_scatter_landed_before_snapshot_is_deduplicated(rng):
    """A scatter enqueued before the search's snapshot, whose batch is still
    in _inflight: no version change, so the delta rows that the device also
    returns must be dropped."""
    eng, _ = _engine(rng)
    fresh = rng.standard_normal((8, DIM)).astype(np.float32)
    eng.put_rows([f"new{i}" for i in range(8)], fresh)
    with eng._lock:  # the first half of _flush_flat, scatter included
        ups = eng._staged_updates
        eng._staged_updates = []
        eng._inflight[99] = (ups, [])
        lay = eng._index.layout
        arr = np.asarray(ups, np.int64)
        rows = arr[:, 0] * lay.phys_cap + arr[:, 1]
        vecs = np.stack([eng.mirrors[s].vector_at(sl) for s, sl in ups])
        eng._index.apply_updates(rows, vecs, np.ones(len(ups), bool))
    dists, keys = eng.search_batch(fresh, 10)
    _no_duplicates(keys)
    assert [row[0] for row in keys] == [f"new{i}" for i in range(8)]
    assert np.isfinite(dists).all()


def test_concurrent_puts_flushes_and_searches_stress(rng):
    eng, data = _engine(rng, n=300)
    queries = data[:16] + 0.01
    stop = threading.Event()
    errors = []

    def writer(w):
        i = 0
        while not stop.is_set():
            v = rng_local[w].standard_normal((4, DIM)).astype(np.float32)
            eng.put_rows([f"w{w}_{i + j}" for j in range(4)], v)
            if i % 3 == 0:
                eng.delete(f"w{w}_{i}")
            i += 4

    def searcher():
        while not stop.is_set():
            try:
                _, keys = eng.search_batch(queries, 10)
                _no_duplicates(keys)
            except Exception as e:  # surfaced below
                errors.append(e)
                return

    rng_local = [np.random.default_rng(s) for s in range(3)]
    eng.start_background_flush(interval_s=0.001)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = ([threading.Thread(target=writer, args=(w,)) for w in range(3)]
               + [threading.Thread(target=searcher) for _ in range(6)])
    try:
        for t in threads:
            t.start()
        stop.wait(2.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
        eng.stop_background_flush()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    _, keys = eng.search_batch(queries, 10)
    _no_duplicates(keys)
