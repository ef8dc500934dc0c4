"""The IVF write cell at a tiny size on the CPU: a whole run reads
`correct` true, the cell takes the write path, two faults planted in the
write path each read `correct` false, and deletes left in the cells serve
no deleted key."""

import pytest

from perfbench.harness import run_cell
from perfbench.tests.tiny import tiny_registry

SEED = 2 ** 31 + 4099
CELL = "ivf-wal-1m.b1-writes"
WRITE_CHECKS = ("stale_answers", "unseen_writes", "lost_writes",
                "base_rows_lost", "wal_tail_missed", "failed_writes")


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny_registry(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("trace", [False, True])
def test_ivf_write_run_is_correct(reg, trace):
    logged = []
    res = run_cell(CELL, SEED, 0.6, trace, device="cpu", registry=reg,
                   log=logged.append)
    assert res["correct"], res["checks"]
    for name in WRITE_CHECKS:
        assert res["checks"][name] == {"value": 0.0, "limit": 0.0}
    assert set(res["metrics"]) == {m["name"]
                                   for m in reg.metrics_for(CELL, trace)}
    assert any(line.startswith("ivf index:") for line in logged)


def test_ivf_write_cell_takes_the_write_path(reg, monkeypatch):
    """The cell runs the durable node, not the read-only path: a data_dir,
    single-row puts and deletes beside the searches, the background flush,
    and the write checks. (`test_perfbench_writes.py` takes every cell but
    the flat write cell for read-only, so its case of this cell fails.)"""
    import collections

    from tpuvdb_torch.engine.engine import VectorDBEngine

    calls = collections.Counter()
    dirs = []
    for name in ("put", "delete", "start_background_flush"):
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
    res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg)
    assert res["correct"], res["checks"]
    assert dirs and all(d is not None for d in dirs)
    assert calls["put"] > 0 and calls["delete"] > 0
    assert calls["start_background_flush"] > 0
    assert set(WRITE_CHECKS) <= set(res["checks"])


def test_deletes_left_in_the_cells_serve_no_deleted_key(reg, monkeypatch):
    """The flush acknowledges deletes but never clears their rows in the
    cells: the probe keeps returning dead rows, and key resolution, which
    asks the doc store whether a row's slot is live, drops every one of
    them, so no deleted key is served (a guard, not a fault the check can
    see; its cost is recall)."""
    from tpuvdb_torch.index.ivf import IVFIndex

    kept = []
    monkeypatch.setattr(IVFIndex, "invalidate_rows",
                        lambda self, rows: kept.extend(rows))
    res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg)
    assert kept and res["correct"], res["checks"]
    assert res["checks"]["stale_answers"]["value"] == 0


def test_deletes_forgotten_fail(reg, monkeypatch):
    """The engine acknowledges a delete and forgets it (the doc store, the
    mirror and the cells keep the row): searches serve a key gone before
    they started."""
    from tpuvdb_torch.core.types import Response
    from tpuvdb_torch.engine.engine import VectorDBEngine

    monkeypatch.setattr(VectorDBEngine, "delete",
                        lambda self, key, replay_mode=False:
                        Response.ok(f"deleted {key}"))
    res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg)
    assert not res["correct"]
    assert res["checks"]["stale_answers"]["value"] > 0


def test_standing_delta_left_out_of_the_snapshot_fails(reg, monkeypatch):
    """Searches leave out IVF's standing delta (flushed inserts not yet in
    the cells): a fresh row is visible while staged, and gone once the
    background flush has moved it."""
    from tpuvdb_torch.engine.engine import VectorDBEngine

    class Hidden(dict):
        def items(self):  # the snapshot's only read of the delta
            return []

    real = VectorDBEngine.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self._ivf_delta = Hidden()
    monkeypatch.setattr(VectorDBEngine, "__init__", init)
    res = run_cell(CELL, SEED, 0.6, False, device="cpu", registry=reg)
    assert not res["correct"]
    assert res["checks"]["unseen_writes"]["value"] > 0
