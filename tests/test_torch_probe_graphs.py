"""CUDA graphs of the IVF probe (tpuvdb_torch/index/probe_graphs.py).

On the CPU:
* `GraphCache`'s policy with capture and replay stood in by callables: a
  key's first call is eager, its second captures and replays, later ones
  replay; at most MAX_GRAPHS captures an index, after which new keys run
  eagerly; a call that finds its key's graph in use runs eagerly; a
  capture that raises leaves the key eager for good and the call answered.
* `IVFIndex`'s replay path, with the CUDA graph stood in by one that
  reruns the captured function into its buffers: a shorter batch after a
  longer one of the same padded size, and a smaller k of the same padded
  k, answer as the eager path, bit for bit.
* `ivf_probe_search` answers a batch and the batch zero-padded to its
  plan's size alike, and a search at padded_k(k) cut to k answers as the
  search at k, bit for bit: what a graph of the padded key relies on.
* The engine publishes the counts in `info()["stats"]` as `ivf_graph_*`,
  and bench/ivf_mixed.py reports them over its window.

On a card (the `cuda` marker; skipped without one): replayed answers,
keys and distances, bit-equal to the eager path on the same index (a
search given the index's own validity takes the eager, filtered path) in
f32, bf16 and int8 cells, both forms, with spill rows; after a shorter
batch, at a smaller k, after writes in place and a failed capture; from
two threads at once. A replay runs the probe kernel as often as an eager
call and counts one launch, as it does. Filtered and PQ searches stay
eager. This file imports no JAX.

    python -m pytest --noconftest -q -m cuda tests/test_torch_probe_graphs.py
"""

from __future__ import annotations

import collections
import json
import threading

import numpy as np
import pytest
import torch

from tpuvdb_torch.index import ivf as ivf_mod
from tpuvdb_torch.index import probe_graphs
from tpuvdb_torch.index.ivf import IVFIndex
from tpuvdb_torch.index.probe_graphs import STATS, GraphCache
from tpuvdb_torch.kernels import ivf_probe


# ------------------------------------------------------------ the policy


class _Calls:
    """Stand-ins for eager, capture and replay that log what ran."""

    def __init__(self, fail_capture=False):
        self.log = []
        self.fail_capture = fail_capture

    def eager(self, x):
        self.log.append(("eager", x))
        return ("eager", x)

    def capture(self, x):
        self.log.append(("capture", x))
        if self.fail_capture:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

        def replay(y):
            self.log.append(("replay", y))
            return ("replay", y)
        return replay


def _counts(cache):
    return {k: v for k, v in cache.stats().items() if v}


def test_cold_then_capture_then_replay():
    cache, calls = GraphCache(), _Calls()
    got = [cache.run("a", calls.eager, calls.capture, i) for i in range(4)]
    assert got == [("eager", 0), ("replay", 1), ("replay", 2), ("replay", 3)]
    assert calls.log == [("eager", 0), ("capture", 1), ("replay", 1),
                         ("replay", 2), ("replay", 3)]
    assert _counts(cache) == {"replays": 3, "captures": 1, "eager_cold": 1}
    assert set(cache.stats()) == set(STATS)


def test_captures_stop_at_the_budget(monkeypatch):
    monkeypatch.setattr(probe_graphs, "MAX_GRAPHS", 2)
    cache, calls = GraphCache(), _Calls()
    for key in "abab":
        cache.run(key, calls.eager, calls.capture, key)
    for _ in range(3):   # a third key never captures, however often seen
        assert cache.run("c", calls.eager, calls.capture, "c")[0] == "eager"
    assert cache.run("a", calls.eager, calls.capture, 1)[0] == "replay"
    assert cache.run("b", calls.eager, calls.capture, 2)[0] == "replay"
    assert _counts(cache) == {"replays": 4, "captures": 2, "eager_cold": 2,
                              "eager_full": 3}
    assert sum(1 for what, _ in calls.log if what == "capture") == 2


def test_a_graph_in_use_sends_the_call_eager():
    cache, calls = GraphCache(), _Calls()
    inner = []

    def replay_then_reenter(y):
        # while this replay holds the graph, a second call of its key
        inner.append(cache.run("a", calls.eager, calls.capture, "inner"))
        return ("replay", y)

    cache.run("a", calls.eager, lambda x: replay_then_reenter, 0)
    assert cache.run("a", calls.eager, lambda x: replay_then_reenter,
                     1) == ("replay", 1)
    assert inner == [("eager", "inner")]
    assert _counts(cache) == {"replays": 1, "captures": 1, "eager_cold": 1,
                              "eager_busy": 1}


def test_threads_never_wait_and_every_call_is_answered():
    cache = GraphCache()
    gate = threading.Event()
    answered = collections.Counter()
    lock = threading.Lock()

    def eager(x):
        return "eager"

    def capture(x):
        def replay(y):
            gate.wait(0.05)      # hold the graph a moment
            return "replay"
        return replay

    def worker():
        for i in range(20):
            got = cache.run("k", eager, capture, i)
            with lock:
                answered[got] += 1

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    gate.set()
    assert not any(t.is_alive() for t in threads)
    st = cache.stats()
    assert sum(answered.values()) == 80
    assert st["replays"] == answered["replay"]
    assert st["eager_cold"] + st["eager_busy"] == answered["eager"]
    assert st["captures"] == 1


def test_a_failed_capture_leaves_the_key_eager_for_good():
    cache, calls = GraphCache(), _Calls(fail_capture=True)
    got = [cache.run("a", calls.eager, calls.capture, i) for i in range(4)]
    assert got == [("eager", i) for i in range(4)]
    assert [w for w, _ in calls.log].count("capture") == 1
    assert _counts(cache) == {"eager_cold": 1, "eager_uncapturable": 3}
    other = _Calls()
    cache.run("b", other.eager, other.capture, 0)
    assert cache.run("b", other.eager, other.capture, 1) == ("replay", 1)


def test_bypass_counts_by_reason():
    cache = GraphCache()
    for reason in ("filtered", "pq", "cpu", "cpu"):
        cache.bypass(reason)
    assert _counts(cache) == {"eager_filtered": 1, "eager_pq": 1,
                              "eager_cpu": 2}


# ------------------------------------------------------ the index's side


def _clustered(n=6000, d=32, n_clusters=12, seed=0):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((n_clusters, d))
    per = n // n_clusters
    return np.concatenate([centers[i] + 0.3 * rng.standard_normal((per, d))
                           for i in range(n_clusters)]).astype(np.float32)


def _index(data, device="cpu", **kw):
    args = dict(nlist=12, nprobe=3, kmeans_iters=4, split_oversized=False,
                cell_cap_quantile=0.5, device=device)
    args.update(kw)
    return IVFIndex.build(data, np.ones(len(data), bool), **args)


class _RerunGraph:
    """A CUDA graph stood in on the CPU: replay() reruns the captured
    function and writes its results into the captured outputs."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for buf, got in zip(self.out, self.fn()):
            buf.copy_(got)


def _rerun_capture(fn, device):
    out = fn()
    return _RerunGraph(fn, out), out, collections.Counter()


@pytest.fixture(scope="module")
def cpu_index():
    data = _clustered()
    idx = _index(data)
    assert idx.stats().spill_rows > 0
    return data, idx


@pytest.mark.parametrize("k,want", [(1, 1), (10, 16), (16, 16), (17, 32),
                                    (200, 256), (256, 256), (300, 320),
                                    (640, 640), (700, 704)])
def test_padded_k_keeps_the_segment_count(k, want):
    assert ivf_probe.padded_k(k) == want
    assert ivf_probe._segments(want) == ivf_probe._segments(k)


def test_padded_k_answers_as_k(cpu_index):
    data, idx = cpu_index
    rng = np.random.default_rng(3)
    q = torch.from_numpy(data[rng.choice(len(data), 24)] + 0.05)
    for k, compact in ((10, False), (10, True), (3, False), (700, False)):
        want = idx.probe(q, k, force_compact=compact)
        got = idx.probe(q, ivf_probe.padded_k(k), force_compact=compact)
        for w, g in zip(want, got):
            assert torch.equal(w, g[:, :k])


def test_padded_batch_answers_as_the_batch(cpu_index):
    data, idx = cpu_index
    rng = np.random.default_rng(1)
    for qn, compact in ((13, False), (13, True), (250, False)):
        q = torch.from_numpy(data[rng.choice(len(data), qn)] + 0.05)
        pad = torch.zeros((ivf_probe.padded_rows(qn), q.shape[1]))
        pad[:qn] = q
        want = idx.probe(q, 10, force_compact=compact)
        got = idx.probe(pad, 10, force_compact=compact)
        for w, g in zip(want, got):
            assert torch.equal(w, g[:qn])


def test_replay_path_matches_eager_after_a_longer_batch(cpu_index,
                                                        monkeypatch):
    data, idx = cpu_index
    monkeypatch.setattr(ivf_mod, "capture_graph", _rerun_capture)
    cache = GraphCache()
    rng = np.random.default_rng(2)
    q256 = data[rng.choice(len(data), 256)] + 0.05
    q250 = np.ascontiguousarray(q256[:250] * -1.0)

    def run(q, k):
        key = (ivf_probe.padded_rows(len(q)), ivf_probe.padded_k(k), 3, False)
        return cache.run(key, idx._probe_to_host, idx._capture_probe, q, k,
                         3, None, False)

    for q, k in ((q256, 10), (q256, 12), (q250, 10), (q256, 16)):
        q = np.ascontiguousarray(q, np.float32)
        got = run(q, k)
        want = idx._probe_to_host(q, k, 3, None, False)
        assert got[0].shape == (len(q), k)
        for w, g in zip(want, got):
            assert torch.equal(w, g)
    assert _counts(cache) == {"replays": 3, "captures": 1, "eager_cold": 1}


def test_engine_publishes_the_counts():
    from tpuvdb_torch.core.config import DBConfig
    from tpuvdb_torch.engine.engine import VectorDBEngine

    data = _clustered(n=3000)
    eng = VectorDBEngine(DBConfig(vector_dim=32, index_type="ivf",
                                  ivf_nlist=12, ivf_nprobe=12),
                         device="cpu")
    try:
        st = eng.info()["stats"]
        assert {f"ivf_graph_{n}" for n in STATS} <= set(st)
        assert all(st[f"ivf_graph_{n}"] == 0 for n in STATS)
        keys = [f"r{i}" for i in range(len(data))]
        assert eng.put_rows(keys, data).success
        eng.flush()
        rows = np.arange(0, len(data), 97)
        for _ in range(3):
            _, got = eng.search_batch(data[rows], 5)
            assert [hits[0] for hits in got] == [keys[r] for r in rows]
        st = eng.info()["stats"]
        assert st["ivf_graph_eager_cpu"] == 3
        assert st["ivf_graph_replays"] == st["ivf_graph_captures"] == 0
    finally:
        eng.close()


def test_mixed_shape_bench_reports_the_counts(capsys):
    from tpuvdb_torch.bench import ivf_mixed

    out = ivf_mixed.main(["--rows", "3000", "--dim", "32", "--nlist", "12",
                          "--nprobe", "4", "--clients", "2", "--batches",
                          "1,3", "--seconds", "0.4", "--warm-seconds", "0.1",
                          "--write-ms", "5", "--puts", "4", "--deletes", "2"],
                         device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["requests_per_s"] > 0 and out["puts"] > 0
    assert out["deletes"] > 0
    assert set(out["graph"]) == set(STATS)
    assert out["graph"]["eager_cpu"] == out["searches"] > 0
    assert out["replay_share"] == 0.0
    assert out["reserved_mib"] == [None, None]


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the IVF probe "
                    "kernels have no CPU mode")


def _eager(idx, q, k, **kw):
    """The eager answers: the index's own validity as a filter."""
    return idx.search(q, k, valid_override=(idx.grouped_valid,
                                            idx.spill_valid), **kw)


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))


@pytest.fixture(scope="module")
def card_data():
    return _clustered(n=24000, d=64, n_clusters=48, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("compact", [False, True])
def test_replay_is_bit_equal_to_eager_on_card(card_data, dtype, compact):
    _card()
    idx = _index(card_data, device="cuda", nlist=48, nprobe=6, dtype=dtype)
    assert idx.stats().spill_rows > 0
    rng = np.random.default_rng(4)
    q = card_data[rng.choice(len(card_data), 256)] + 0.05
    name = {(False, False): "LAUNCHES_EXPANDED",
            (True, False): "LAUNCHES_COMPACT",
            (False, True): "LAUNCHES_EXPANDED_INT8",
            (True, True): "LAUNCHES_COMPACT_INT8"}[(compact,
                                                    dtype == torch.int8)]
    want = _eager(idx, q, 10, force_compact=compact)
    for _ in range(2):   # cold, then the capture and its replay
        _same(idx.search(q, 10, force_compact=compact), want)
    before = getattr(ivf_probe, name)
    got = idx.search(q, 10, force_compact=compact)
    assert getattr(ivf_probe, name) == before + 1
    _same(got, want)
    # a shorter batch of the same padded size: the rows of the longer one
    # are zeroed, not left
    q250 = np.ascontiguousarray(q[:250][::-1])
    _same(idx.search(q250, 10, force_compact=compact),
          _eager(idx, q250, 10, force_compact=compact))
    # a k that pads to the same 16: the same graph, cut to 13
    _same(idx.search(q, 13, force_compact=compact),
          _eager(idx, q, 13, force_compact=compact))
    st = idx.graphs.stats()
    assert (st["replays"], st["captures"], st["eager_cold"]) == (4, 1, 1)
    assert st["eager_filtered"] == 3


@pytest.mark.cuda
def test_a_replay_counts_the_launches_it_runs_on_card(card_data):
    _card()
    from torch.profiler import ProfilerActivity, profile

    idx = _index(card_data, device="cuda", nlist=48, nprobe=6)
    q = np.ascontiguousarray(card_data[:256])

    def traced(fn):
        """(probe_mma_kernel launches the device ran, counted launches)."""
        before = ivf_probe.LAUNCHES_EXPANDED
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ran = sum(1 for e in prof.events() if "probe_mma_kernel" in e.name)
        return ran, ivf_probe.LAUNCHES_EXPANDED - before

    eager = traced(lambda: _eager(idx, q, 10))
    for _ in range(2):   # cold, then the capture
        idx.search(q, 10)
    replayed = traced(lambda: idx.search(q, 10))
    assert idx.graphs.stats()["replays"] == 2
    assert eager[0] >= 1
    assert replayed == eager == (eager[0], 1)


@pytest.mark.cuda
def test_replay_reads_writes_in_place_on_card(card_data):
    _card()
    data = card_data[:20000]
    idx = _index(data, device="cuda", nlist=48, nprobe=6)
    q = np.ascontiguousarray(data[:256])
    for _ in range(2):
        idx.search(q, 10)
    ptr = idx.grouped_valid.data_ptr()
    idx.invalidate_rows(np.arange(0, 256, 2))
    got = idx.search(q, 10)
    _same(got, _eager(idx, q, 10))
    assert not np.isin(got[1], np.arange(0, 256, 2)).any()
    new = np.ascontiguousarray(card_data[20000:20064])
    assert idx.append_rows(np.arange(20000, 20064), new)
    assert idx.grouped_valid.data_ptr() == ptr
    for _ in range(3):   # cold, capture, replay: each finds the new rows
        got = idx.search(new, 10)
        assert (got[1][:, 0] == np.arange(20000, 20064)).all()
    got = idx.search(q, 10)
    _same(got, _eager(idx, q, 10))
    assert idx.graphs.stats()["captures"] == 2   # the 256 and 64 batches


@pytest.mark.cuda
def test_two_threads_on_one_index_on_card(card_data):
    _card()
    idx = _index(card_data, device="cuda", nlist=48, nprobe=6)
    rng = np.random.default_rng(5)
    batches = [np.ascontiguousarray(
        card_data[rng.choice(len(card_data), 256)] + 0.05)
        for _ in range(4)]
    wants = [_eager(idx, b, 10) for b in batches]
    errors = []

    def worker(seed):
        order = np.random.default_rng(seed).permutation(40) % 4
        try:
            for i in order:
                _same(idx.search(batches[i], 10), wants[i])
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in (6, 7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    st = idx.graphs.stats()
    assert st["replays"] + st["eager_cold"] + st["eager_busy"] == 80
    assert st["replays"] > 0


@pytest.mark.cuda
def test_a_capture_that_fails_answers_eagerly_on_card(card_data,
                                                      monkeypatch):
    _card()
    idx = _index(card_data, device="cuda", nlist=48, nprobe=6)
    q = np.ascontiguousarray(card_data[:64])
    want = _eager(idx, q, 10)
    probe = idx.probe

    def probe_that_reads_back(*args, **kw):
        out = probe(*args, **kw)
        out[0].sum().item()      # a host read: illegal in a capture
        return out

    monkeypatch.setattr(idx, "probe", probe_that_reads_back)
    for _ in range(3):
        _same(idx.search(q, 10), want)
    st = idx.graphs.stats()
    assert (st["eager_cold"], st["eager_uncapturable"], st["replays"]) == (
        1, 2, 0)
    monkeypatch.setattr(idx, "probe", probe)
    q2 = np.ascontiguousarray(card_data[64:96])
    for _ in range(3):
        _same(idx.search(q2, 10), _eager(idx, q2, 10))
    assert idx.graphs.stats()["replays"] == 2


@pytest.mark.cuda
def test_filtered_and_pq_searches_stay_eager_on_card(card_data):
    _card()
    idx = _index(card_data, device="cuda", nlist=48, nprobe=6)
    q = np.ascontiguousarray(card_data[:32])
    g, s = idx.masked_valid(np.arange(0, len(card_data), 3))
    for _ in range(3):
        got = idx.search(q, 10, valid_override=(g, s))
        assert (got[1][got[1] >= 0] % 3 == 0).all()
    assert _counts(idx.graphs) == {"eager_filtered": 3}
    pq = _index(card_data, device="cuda", nlist=48, nprobe=6, pq_subq=8)
    for _ in range(3):
        pq.search(q, 10)
    assert _counts(pq.graphs) == {"eager_pq": 3}
