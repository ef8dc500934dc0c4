"""The write-mixed path at a tiny size on the CPU: the plan, the live-set
reference against brute force, the faults a write cell can have planted
under a whole run (each reads `correct` false), and the read-only cells'
path left as it was: no writer, no data_dir, the same engine calls."""

import collections
import json
import os
import threading

import numpy as np
import pytest

from perfbench import writes
from perfbench.harness import run_cell
from perfbench.registry import Registry
from perfbench.tests.tiny import cells, tiny_registry

SEED = 2 ** 31 + 8191
CELL = "flat-wal-1m.b1-writes"
READ_ONLY = [c for c in cells() if c != CELL]


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny_registry(str(tmp_path_factory.mktemp("tiny")))


def _plan(params, seed, seconds=2.0, base=5000):
    import torch
    centres = torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
    return writes.WritePlan(params, base, centres, 0.4, True, seconds,
                            seed, seed + 1)


def test_plan_keeps_the_mix_and_the_schedule_across_seeds():
    params = {"write_rate": 500, "warm_writes": 30,
              "write_mix": {"insert": 0.8, "overwrite": 0.1, "delete": 0.1}}
    assert list(writes.mix_block(params["write_mix"])) == [0] * 8 + [1, 2]
    a, b = _plan(params, 1), _plan(params, 2)
    assert a.n == b.n == 30 + 1000 + 1
    for p in (a, b):
        for lo in range(0, p.n - 10, 10):
            assert sorted(p.ops[lo:lo + 10]) == [0] * 8 + [1, 2]
        touched = p.target[p.ops != writes.INSERT]
        assert len(set(touched.tolist())) == touched.size  # once each
        assert p.vectors.shape[0] == int((p.ops != writes.DELETE).sum())
    assert not np.array_equal(a.ops, b.ops)
    with pytest.raises(ValueError):
        writes.mix_block({"insert": 0.5, "delete": 0.4})


def test_versions_follow_the_acknowledged_writes():
    params = {"write_rate": 50, "warm_writes": 0,
              "write_mix": {"insert": 0.5, "overwrite": 0.25,
                            "delete": 0.25}}
    p = _plan(params, 3, seconds=1.0, base=40)
    log = writes.WriteLog(p.n)
    for i in range(p.n):
        log.record(p, i, float(i), float(i), i + 0.5, i != 5)
    v = writes.versions(p, log, 40)
    for i in range(p.n):
        key = p.key(i)
        if i == 5:
            continue  # a failed write makes no version
        if p.ops[i] == writes.DELETE:
            assert v.current[key] is None
            assert v.died_ack[int(p.target[i])] == i + 0.5
        else:
            row = 40 + int(p.vec_of[i])
            assert v.born_ack[row] == i + 0.5 and row in v.rows_of(key)
    assert v.rows_of("r3") in ([3], v.of_key.get("r3"))
    assert v.rows_of("nothing") == []


def test_live_reference_matches_brute_force():
    knn_live = Registry().reference("knn_live")
    rng = np.random.default_rng(5)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    extra = rng.standard_normal((80, 16)).astype(np.float32)
    born = np.concatenate([np.full(300, -np.inf), rng.uniform(0, 10, 80)])
    died = np.where(rng.random(380) < 0.3, born + rng.uniform(0, 5, 380),
                    np.inf)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    at = rng.uniform(0, 12, 12)
    ids, d = knn_live.exact_topk_live(q, [base, extra], born, died, at, 5)
    allv = np.concatenate([base, extra]).astype(np.float64)
    for i in range(12):
        live = (born < at[i]) & (at[i] <= died)
        dd = ((allv - q[i].astype(np.float64)) ** 2).sum(1)
        dd[~live] = np.inf
        want = np.argsort(dd, kind="stable")[:5]
        np.testing.assert_array_equal(ids[i], want)
        np.testing.assert_allclose(d[i], dd[want], rtol=1e-12)


def _mix(reg, **over):
    """Writes the tiny mix with `over` for one test; returns a restorer."""
    path = os.path.join(reg.root, "traffic", "mixed-b1-writes.json")
    mix = json.load(open(path))
    json.dump({**mix, **over}, open(path, "w"))
    return lambda: json.dump(mix, open(path, "w"))


def test_whole_write_run_is_correct(reg):
    logged = []
    res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg,
                   log=logged.append)
    assert res["correct"], res["checks"]
    for name in ("stale_answers", "unseen_writes", "lost_writes",
                 "base_rows_lost", "wal_tail_missed", "failed_writes"):
        assert res["checks"][name] == {"value": 0.0, "limit": 0.0}
    assert set(res["metrics"]) == {m["name"]
                                   for m in reg.metrics_for(CELL, False)}
    assert any("wal_replayed" in line and "of a tail of 0 " not in line
               for line in logged if line.startswith("read back"))
    for start in ("recovered in", "writes ", "window: checkpoints"):
        assert any(line.startswith(start) for line in logged), start
    assert not any(t.name == "perfbench-writer"
                   for t in threading.enumerate())


def test_delete_still_seen_by_searches_fails(reg, monkeypatch):
    from tpuvdb_torch.engine.engine import VectorDBEngine
    from tpuvdb_torch.core.types import Response

    # the engine forgets every delete but acknowledges it
    monkeypatch.setattr(VectorDBEngine, "delete",
                        lambda self, key, replay_mode=False:
                        Response.ok(f"deleted {key}"))
    restore = _mix(reg, write_mix={"insert": 0.5, "overwrite": 0.1,
                                   "delete": 0.4})
    try:
        res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg)
    finally:
        restore()
    assert not res["correct"]
    assert res["checks"]["stale_answers"]["value"] > 0


def test_base_rows_lost_in_the_reopen_fail(reg, monkeypatch):
    from tpuvdb_torch.engine.engine import VectorDBEngine

    # the recovery after the crash forgets every 10th base row of the
    # checkpoint it restores (set-up's opening of the node is sound)
    real = VectorDBEngine._recover
    opened = collections.Counter()

    def forgetting(self):
        real(self)
        opened[self.config.wal_enabled] += 1
        if self.config.wal_enabled and opened[True] > 1:
            for key in [e.key for e in self.docstore.entries()
                        if e.key.startswith("r")][::10]:
                self.delete(key, replay_mode=True)
    monkeypatch.setattr(VectorDBEngine, "_recover", forgetting)
    res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg)
    assert not res["correct"]
    assert res["checks"]["base_rows_lost"]["value"] > 0


def test_put_hidden_until_a_flush_fails(reg, monkeypatch):
    from tpuvdb_torch.engine.engine import VectorDBEngine

    # searches leave out the host delta scan of staged and in-flight rows,
    # and the background flush waits long enough for every search to see it
    monkeypatch.setattr(VectorDBEngine, "_merge_delta",
                        staticmethod(lambda q, dists, rows, delta, total:
                                     (dists, rows)))
    real = VectorDBEngine.start_background_flush
    monkeypatch.setattr(VectorDBEngine, "start_background_flush",
                        lambda self, interval_s=0.05: real(self, 30.0))
    res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg)
    assert not res["correct"]
    assert res["checks"]["unseen_writes"]["value"] > 0


def test_dropped_wal_record_fails(reg, monkeypatch):
    from tpuvdb_torch.store.wal import WriteAheadLog

    real = WriteAheadLog.append
    count = collections.Counter()

    def dropping(self, op, key, *a, **kw):
        count["n"] += 1
        if count["n"] % 7 == 0:
            return 0  # acknowledged, never written
        return real(self, op, key, *a, **kw)

    monkeypatch.setattr(WriteAheadLog, "append", dropping)
    res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg)
    assert not res["correct"]
    assert res["checks"]["lost_writes"]["value"] > 0


@pytest.mark.parametrize("cell", READ_ONLY)
def test_read_only_cells_take_the_old_path(reg, cell, monkeypatch):
    """No writer thread, no data_dir, and the engine calls the harness
    made before the write path came: one load, one flush, the warm-up's
    searches, the window's, one info() and one close()."""
    from tpuvdb_torch.engine.engine import VectorDBEngine

    calls = collections.Counter()
    dirs = []
    for name in ("put_rows", "put", "delete", "flush", "warm_search",
                 "search_batch", "info", "close", "start_background_flush",
                 "save_checkpoint", "get"):
        real = getattr(VectorDBEngine, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(self, *a, **kw)
        monkeypatch.setattr(VectorDBEngine, name, counted)
    real_init = VectorDBEngine.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        dirs.append(self.data_dir)
    monkeypatch.setattr(VectorDBEngine, "__init__", init)
    threads = threading.active_count()
    res = run_cell(cell, SEED, 0.3, False, device="cpu", registry=reg)
    assert res["correct"]
    assert dirs == [None]
    assert threading.active_count() == threads
    warm = int(reg.traffic(reg.workload(cell)["traffic"])["warm_calls"])
    assert calls["search_batch"] == warm + res["attempted"] // int(
        reg.traffic(reg.workload(cell)["traffic"])["batch"])
    assert {n: c for n, c in calls.items() if n != "search_batch"} == {
        "put_rows": 1, "flush": 1, "warm_search": 1, "info": 1, "close": 1}
    assert set(res["metrics"]) == {m["name"]
                                   for m in reg.metrics_for(cell, False)}
    assert set(res["checks"]) == {"bad_answers", "miss_share", "dist_gap",
                                  "failed_calls", "unchecked"}
