"""A checkpoint rotates the port's WAL out of the segment it covers.

`WriteAheadLog.truncate_through(seq)` removes the active segment too when
seq covers every record written, and the next append opens a new one. So
a reopen after a checkpoint reads no record the checkpoint holds (the
reference keeps the active segment: one large `put_rows` batch stays in
it and every reopen reads it through). Held here:
* the log alone, on the python and the native writer: records after the
  checkpoint go to a new segment, sequence numbers go on from the marker,
  and a truncate that does not cover the last record keeps the segment;
* the engine: after a checkpoint and a WAL tail (puts, an overwrite, a
  delete, then a crash that closes only the WAL), a reopen reads only
  records past the checkpoint, and serves the same results and every
  acknowledged write; the JAX engine reopens the same data_dir alike.
"""

import os

import numpy as np
import pytest

from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch import DBConfig, VectorDBEngine, native
from tpuvdb_torch.core.types import VectorData
from tpuvdb_torch.store import wal as wal_mod
from tpuvdb_torch.store.wal import WriteAheadLog

DIM = 16


def _records(n, start=0):
    return [{"op": "put", "key": f"k{i}",
             "vector": np.full(DIM, i, np.float32)}
            for i in range(start, start + n)]


@pytest.mark.parametrize("backend", ["python", "native"])
def test_checkpoint_rotates_the_active_segment(tmp_path, backend):
    if backend == "native" and not native.available():
        pytest.skip("the native host runtime does not build here")
    log = WriteAheadLog(str(tmp_path), backend=backend, fsync=False)
    log.append_batch(_records(50))
    first = log._cur_path
    assert log.truncate_through(log.last_seq - 1) == 0  # one not covered
    assert os.path.exists(first)
    covered = log.last_seq
    assert log.truncate_through(covered) == 1
    assert log._segments() == []
    log.append_batch(_records(5, start=50))
    assert log._segments() != [first] and len(log._segments()) == 1
    log.close()
    reopened = WriteAheadLog(str(tmp_path), backend=backend, fsync=False)
    recs = list(reopened.iter_records())
    assert [r["seq"] for r in recs] == list(range(covered + 1,
                                                  covered + 6))
    assert [r["key"] for r in recs] == [f"k{i}" for i in range(50, 55)]
    assert reopened.last_seq == covered + 5
    reopened.close()


def _cfg(cls, **kw):
    base = dict(vector_dim=DIM, shard_count=2, shard_capacity=4096,
                block_size=128, checkpoint_every_puts=10**9,
                compact_every_puts=10**9)
    base.update(kw)
    return cls(**base)


def test_reopen_after_a_checkpoint_reads_no_covered_segment(
        rng, tmp_path, monkeypatch):
    d = str(tmp_path)
    n = 600
    data = rng.standard_normal((n, DIM)).astype(np.float32)
    eng = VectorDBEngine(_cfg(DBConfig), data_dir=d, device="cpu")
    assert eng.put_rows([f"k{i}" for i in range(n)], data).success
    assert eng.save_checkpoint()
    covered = eng.wal.last_seq
    assert covered >= n and eng.wal._segments() == []
    # the WAL tail after the checkpoint, then a crash (only the WAL closes)
    assert eng.put(VectorData(key="k7", vector=data[8] + 0.25,
                              metadata={"g": "x"})).success
    assert eng.put_batch([VectorData(key=f"tail{i}", vector=data[i] + 0.5)
                          for i in range(20)]).success
    assert eng.delete("k11").success
    q = rng.standard_normal((8, DIM)).astype(np.float32)
    want = eng.search_batch(q, 10)
    count = eng.count()
    eng.wal.close()

    read = []
    iter_segment = WriteAheadLog._iter_segment

    def spy(self, path):
        for rec in iter_segment(self, path):
            read.append(rec["seq"])
            yield rec

    monkeypatch.setattr(wal_mod.WriteAheadLog, "_iter_segment", spy)
    port = VectorDBEngine(_cfg(DBConfig), data_dir=d, device="cpu")
    assert read and min(read) > covered  # no record the checkpoint holds
    assert port.count() == count
    got = port.search_batch(q, 10)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    assert port.get("k7").vector_data.metadata == {"g": "x"}
    assert not port.get("k11").success
    assert port.get("tail19").success
    port.close()

    # the reference reopens the port's rotated data_dir
    monkeypatch.undo()
    jeng = JaxEngine(_cfg(JaxConfig), data_dir=d)
    assert jeng.count() == count
    jd, jk = jeng.search_batch(q, 10)
    assert jk == want[1]
    np.testing.assert_allclose(jd, want[0], rtol=1e-5, atol=1e-4)
    jeng.close()
