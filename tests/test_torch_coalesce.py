"""Search group commit in the port (tpuvdb_torch/engine/coalesce.py and the
engine's hook) against the JAX package's (tpuvdb/engine/coalesce.py).

Mirrors tests/test_coalesce.py on device="cpu": concurrent search_batch
calls share one direct call and return what solo calls return; groups
stack, overlap in flight, keep k apart, never split a batch and pass
exceptions to every member; warm_search runs the reference's ladder.
One divergence by design: the port stacks at the group's own row count,
with no power-of-two pad (the reference's pad bounds XLA compiles). The
new cases show a stack of three batches (not a power of two) launches no
padded rows and gives each caller its solo answer, and that a coalesced
port engine answers as the coalesced JAX engine does.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tpuvdb import native as jax_native
from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.engine.coalesce import SearchCoalescer as JaxCoalescer
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.engine.coalesce import SearchCoalescer
from tpuvdb_torch.engine.engine import VectorDBEngine

WAIT_S = 30


@pytest.fixture(autouse=True)
def _no_reference_build(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)


def _cfg(cls, n, dim, coalesce, **kw):
    return cls(vector_dim=dim, shard_count=2, shard_capacity=n,
               wal_enabled=False, search_coalesce=coalesce,
               checkpoint_every_puts=10 ** 9, compact_every_puts=10 ** 9,
               **kw)


def _mk_engine(n=2000, dim=16, coalesce=True, **kw):
    eng = VectorDBEngine(_cfg(DBConfig, n, dim, coalesce, **kw),
                         device="cpu")
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    eng.put_rows([f"r{i}" for i in range(n)], vecs)
    eng.flush()
    return eng, vecs


def test_concurrent_matches_solo(rng):
    eng, vecs = _mk_engine()
    queries = [vecs[rng.integers(0, len(vecs), 32)]
               + 0.01 * rng.standard_normal((32, vecs.shape[1])).astype(
                   np.float32)
               for _ in range(12)]
    solo = [eng._search_batch_direct(q.astype(np.float32), 5, False)
            for q in queries]
    with ThreadPoolExecutor(max_workers=12) as pool:
        got = list(pool.map(lambda q: eng.search_batch(q, 5), queries,
                            timeout=WAIT_S))
    for (sd, sk), (gd, gk) in zip(solo, got):
        np.testing.assert_allclose(np.asarray(gd), np.asarray(sd),
                                   rtol=1e-5, atol=1e-5)
        assert [list(r) for r in gk] == [list(r) for r in sk]


def _stacking_run(cls, sizes):
    """A leader's direct call blocks until the followers have queued; with
    inflight=1 they stack into the next call. Returns the row counts of
    the direct calls and each caller's result."""
    calls = []
    leader_in_direct = threading.Event()
    followers_queued = threading.Event()

    def direct(q, k, overfetch):
        calls.append(q.shape[0])
        if len(calls) == 1:
            leader_in_direct.set()
            assert followers_queued.wait(WAIT_S)
            time.sleep(0.05)  # let followers reach the leader lock
        # each row answers with its own first query value, so a caller can
        # tell it got its own rows back
        return (np.repeat(q[:, :1], k, axis=1),
                [[f"x{float(r[0])}"] * k for r in q])

    co = cls(direct, max_rows=4096, inflight=1)

    def call(i):
        if i > 0:
            assert leader_in_direct.wait(WAIT_S)
        q = np.full((sizes[i], 4), float(i), np.float32)
        return co.search(q, 3, False)

    with ThreadPoolExecutor(max_workers=len(sizes)) as pool:
        lead = pool.submit(call, 0)
        assert leader_in_direct.wait(WAIT_S)
        folls = [pool.submit(call, i) for i in range(1, len(sizes))]
        time.sleep(0.1)  # followers enqueue + block on the leader lock
        followers_queued.set()
        res = [lead.result(WAIT_S)] + [f.result(WAIT_S) for f in folls]
    return calls, res


def test_groups_actually_stack():
    """Batches arriving while a direct call is in flight share the NEXT
    call, at their own row count: the JAX coalescer pads 24 rows to 32,
    the port runs 24."""
    calls, res = _stacking_run(SearchCoalescer, [8, 8, 8, 8])
    assert all(r[0].shape == (8, 3) for r in res)
    assert calls == [8, 24]
    jax_calls, _ = _stacking_run(JaxCoalescer, [8, 8, 8, 8])
    assert jax_calls == [8, 32]


def test_stack_of_three_launches_no_padded_rows():
    """Three followers of 5, 6 and 7 rows (18, not a power of two) stack
    into one call of exactly 18 rows, and each caller gets back exactly its
    own rows, as a solo call would give them."""
    sizes = [4, 5, 6, 7]
    calls, res = _stacking_run(SearchCoalescer, sizes)
    assert calls == [4, 18]
    for i, (d, keys) in enumerate(res):
        assert d.shape == (sizes[i], 3)
        np.testing.assert_array_equal(d, np.full((sizes[i], 3), float(i)))
        assert keys == [[f"x{float(i)}"] * 3] * sizes[i]


def test_stacked_engine_group_equals_solo_calls(rng):
    """On an engine: a stacked group of three batches (9 + 10 + 12 rows)
    gives each caller its solo answer, and the engine searched 31 rows,
    not 32."""
    eng, vecs = _mk_engine(n=600)
    seen = []
    direct = eng._search_batch_direct
    gate = threading.Event()

    def spy(q, k, overfetch):
        seen.append(q.shape[0])
        if len(seen) == 1:
            assert gate.wait(WAIT_S)
        return direct(q, k, overfetch)

    eng._search_coalescer._direct = spy
    eng._search_coalescer._inflight = 1
    eng._search_coalescer._leader.clear()
    batches = [vecs[i * 40:i * 40 + n] + 0.01 for i, n in
               enumerate((3, 9, 10, 12))]
    solo = [direct(b, 4, False) for b in batches]
    with ThreadPoolExecutor(max_workers=4) as pool:
        lead = pool.submit(eng.search_batch, batches[0], 4)
        while not seen:
            time.sleep(0.01)
        folls = [pool.submit(eng.search_batch, b, 4) for b in batches[1:]]
        time.sleep(0.2)
        gate.set()
        got = [lead.result(WAIT_S)] + [f.result(WAIT_S) for f in folls]
    assert seen == [3, 31]
    for (sd, sk), (gd, gk) in zip(solo, got):
        assert gk == sk
        np.testing.assert_allclose(gd, sd, rtol=1e-6)
    assert eng.info()["search_groups"] == {1: 1, 3: 1}


def test_mixed_k_separate_groups():
    eng, vecs = _mk_engine(n=500)
    q = vecs[:16].astype(np.float32)
    ks = (3, 5, 3, 5, 7, 3, 5, 7)
    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(eng.search_batch, q, k) for k in ks]
        out = [f.result(WAIT_S) for f in futs]
    for (d, keys), k in zip(out, ks):
        assert np.asarray(d).shape[0] == 16
        assert len(keys[0]) >= k
        assert keys[0][0] == "r0"  # self-query: the row itself


def test_exception_propagates_to_group():
    def direct(q, k, overfetch):
        raise RuntimeError("boom")

    co = SearchCoalescer(direct, max_rows=64)
    with pytest.raises(RuntimeError, match="boom"):
        co.search(np.zeros((4, 4), np.float32), 2, False)


def test_max_rows_never_splits_a_batch():
    calls = []

    def direct(q, k, overfetch):
        calls.append(q.shape[0])
        return (np.zeros((q.shape[0], k), np.float32),
                [[None] * k for _ in range(q.shape[0])])

    co = SearchCoalescer(direct, max_rows=16)
    d, keys = co.search(np.zeros((40, 4), np.float32), 2, False)
    assert d.shape == (40, 2) and calls == [40]


def test_warm_search_ladder():
    """warm_search runs the base batch plus every power-of-two stack up to
    min(coalesce_max, max_stack): the JAX engine's ladder."""
    eng, _ = _mk_engine(n=500)
    assert eng.warm_search(5, 32, max_stack=128) == [32, 64, 128]
    assert eng.warm_search(5, 64, max_stack=256) == [64, 128, 256]
    eng2, _ = _mk_engine(n=500, coalesce=False)
    assert eng2.warm_search(5, 48) == [48]
    jax_eng = JaxEngine(_cfg(JaxConfig, 500, 16, True))
    jax_eng.put_rows(["a"], np.ones((1, 16), np.float32))
    assert jax_eng.warm_search(5, 32, max_stack=128) == \
        eng.warm_search(5, 32, max_stack=128)


def test_groups_overlap_in_flight():
    """With inflight > 1, a caller arriving while a leader's direct call is
    in flight does not wait for it."""
    leader_in_direct = threading.Event()
    release_leader = threading.Event()

    def direct(q, k, overfetch):
        if not leader_in_direct.is_set():
            leader_in_direct.set()
            assert release_leader.wait(WAIT_S)
        return (np.zeros((q.shape[0], k), np.float32),
                [["x"] * k for _ in range(q.shape[0])])

    co = SearchCoalescer(direct, max_rows=4096, inflight=2)
    with ThreadPoolExecutor(max_workers=2) as pool:
        lead = pool.submit(
            co.search, np.zeros((8, 4), np.float32), 3, False)
        assert leader_in_direct.wait(WAIT_S)
        t0 = time.perf_counter()
        follow = co.search(np.zeros((8, 4), np.float32), 3, False)
        follow_s = time.perf_counter() - t0
        assert follow[0].shape == (8, 3)
        assert not lead.done()      # follower finished while leader waits
        release_leader.set()
        assert lead.result(WAIT_S)[0].shape == (8, 3)
    assert follow_s < 2.0


def test_solo_caller_shape_unchanged():
    calls = []

    def direct(q, k, overfetch):
        calls.append(q.shape[0])
        return (np.zeros((q.shape[0], k), np.float32),
                [[None] * k for _ in range(q.shape[0])])

    co = SearchCoalescer(direct, max_rows=4096)
    co.search(np.zeros((12, 4), np.float32), 2, False)
    assert calls == [12]


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_coalesced_engine_answers_as_jax(mode, rng):
    """12 concurrent search_batch calls on a coalesced port engine against
    the coalesced JAX engine on the same rows: equal keys in "exact"
    (distances within rtol 1e-5 + atol 1e-5); in "approx" (the port's
    bucketed scan, the reference's exact approx_max_k on the CPU) recall
    of 0.95 or better."""
    n, dim = 1500, 16
    data = rng.standard_normal((n, dim)).astype(np.float32)
    keys = [f"r{i}" for i in range(n)]
    queries = [rng.standard_normal((7, dim)).astype(np.float32)
               for _ in range(12)]
    eng = VectorDBEngine(_cfg(DBConfig, n, dim, True, search_mode=mode),
                         device="cpu")
    jax_eng = JaxEngine(_cfg(JaxConfig, n, dim, True, search_mode=mode))
    for e in (eng, jax_eng):
        e.put_rows(keys, data)
    with ThreadPoolExecutor(max_workers=12) as pool:
        got = list(pool.map(lambda q: eng.search_batch(q, 10), queries,
                            timeout=WAIT_S))
    hit = total = 0
    for q, (gd, gk) in zip(queries, got):
        wd, wk = jax_eng.search_batch(q, 10)
        for i in range(len(q)):
            g = [x for x in gk[i] if x is not None][:10]
            w = [x for x in wk[i] if x is not None][:10]
            if mode == "exact":
                assert g == w
                np.testing.assert_allclose(gd[i][:10], wd[i][:10],
                                           rtol=1e-5, atol=1e-5)
            hit += len(set(g) & set(w))
            total += 10
    assert hit / total >= 0.95
