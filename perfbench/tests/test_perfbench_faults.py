"""The check fails what it must: the control (the reference in TF32 in the
program's place) and the faults a search cell can have, planted in the
timed path of a whole tiny run: an answer altered where it is produced,
and half of the batch left out with the rest's answers in its place."""

import numpy as np
import pytest

from perfbench.control import control_numbers
from perfbench.harness import run_cell
from perfbench.tests.tiny import cells, tiny_registry

SEED = 2 ** 31 + 4099


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny_registry(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", cells())
def test_tf32_control_is_not_correct(reg, cell, seed):
    out = control_numbers(cell, seed, "tf32", "cpu", reg)
    assert not out["correct"]
    assert out["numbers"]["dist_gap"] > reg.config(
        reg.workload(cell)["config"])["check"]["dist_gap"]


def _index_class(reg, cell):
    from tpuvdb_torch.index.exact import DeviceExactIndex
    from tpuvdb_torch.index.ivf import IVFIndex
    cfg = reg.config(reg.workload(cell)["config"])
    return IVFIndex if cfg["dbconfig"]["index_type"] == "ivf" \
        else DeviceExactIndex


@pytest.mark.parametrize("cell", cells())
def test_altered_key_fails(reg, cell, monkeypatch):
    cls = _index_class(reg, cell)
    real = cls.search

    def altered(self, queries, k, *a, **kw):
        dists, rows = real(self, queries, k, *a, **kw)
        rows = rows.copy()
        rows[:, 0] = rows[:, -1] + 1  # the best hit now names another row
        return dists, rows

    monkeypatch.setattr(cls, "search", altered)
    res = run_cell(cell, SEED, 0.3, False, device="cpu", registry=reg)
    assert not res["correct"]


@pytest.mark.parametrize("cell", cells())
def test_altered_distance_fails(reg, cell, monkeypatch):
    cls = _index_class(reg, cell)
    real = cls.search

    def altered(self, queries, k, *a, **kw):
        dists, rows = real(self, queries, k, *a, **kw)
        return dists + np.float32(1e-4), rows

    monkeypatch.setattr(cls, "search", altered)
    res = run_cell(cell, SEED, 0.3, False, device="cpu", registry=reg)
    assert not res["correct"]
    assert res["checks"]["dist_gap"]["value"] > \
        res["checks"]["dist_gap"]["limit"]


@pytest.mark.parametrize("cell", [c for c in cells() if "b1" not in c])
def test_half_the_batch_left_out_fails(reg, cell, monkeypatch):
    from tpuvdb_torch.engine.engine import VectorDBEngine
    real = VectorDBEngine._search_batch_direct

    def half(self, queries, k, overfetch=False):
        h = max(1, queries.shape[0] // 2)
        dists, keys = real(self, queries[:h], k, overfetch)
        reps = -(-queries.shape[0] // h)
        return (np.concatenate([dists] * reps)[:queries.shape[0]],
                (keys * reps)[:queries.shape[0]])

    monkeypatch.setattr(VectorDBEngine, "_search_batch_direct", half)
    res = run_cell(cell, SEED, 0.3, False, device="cpu", registry=reg)
    assert not res["correct"]
